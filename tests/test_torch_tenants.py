"""The port's tenant table (veles_torch/serving/tenants.py) and its
weighted-fair batchers against the JAX package's: the same tenant file
and submission sequence give the same admit/429 decisions and
Retry-After, the same resolver output and ``describe()``, the same
dispatch order in the ``MicroBatcher`` and the same KV slot-grant order
in the ``ContinuousBatcher`` (one slot, a bronze backlog and a gold
request arriving last); with no table installed both stay first in
first out."""

import json
import threading
import time

import numpy
import pytest

from veles.serving import MicroBatcher as JaxMicroBatcher
from veles.serving import tenants as JT
from veles.serving.decode import ContinuousBatcher as JaxContinuousBatcher
from veles_torch.serving import MicroBatcher, tenants as TT
from veles_torch.serving.decode import ContinuousBatcher

from tests.torch_monitor import port_model_health_isolation  # noqa: F401

DOC = {"default": "anon",
       "slo": {"p99_ms": 200.0, "target": 0.01},
       "tenants": {"acme": {"rps": 2.0, "burst": 3, "priority": "gold"},
                   "anon": {"rps": 1.0, "burst": 1, "priority": "bronze"},
                   "bulk": {"priority": "batch"}}}


@pytest.fixture
def tables():
    yield
    JT.set_table(None)
    TT.set_table(None)


def test_quota_decisions_and_resolver_agree(tmp_path, tables):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(DOC))
    jt, tt = JT.TenantTable.from_file(str(path)), \
        TT.TenantTable.from_file(str(path))
    keys = ["acme", None, "acme", "mystery", "acme", "bulk", "", "acme",
            None]
    assert [jt.resolve(k) for k in keys] == [tt.resolve(k) for k in keys]
    assert jt.names() == tt.names()
    for tenant in jt.names() + ["other"]:
        assert jt.weight(tenant) == tt.weight(tenant)
        assert jt.best_effort(tenant) == tt.best_effort(tenant)
    # the same arrivals on one injected clock: the same admits and waits
    now = 1000.0
    for quota_j, quota_t in ((jt._quotas[n], tt._quotas[n])
                             for n in ("acme", "anon")):
        quota_j._stamp = quota_t._stamp = now
        got = []
        for dt in (0.0, 0.0, 0.0, 0.0, 0.1, 0.5, 0.5, 2.0):
            now += dt
            got.append((quota_j.admit(now), quota_t.admit(now)))
        for a, b in got:
            assert a[0] == b[0] and a[1] == pytest.approx(b[1], abs=1e-12)
        assert [a[0] for a, _ in got].count(False) > 0
    dj, dt_ = jt.describe(), tt.describe()
    assert sorted(dj) == sorted(dt_)
    assert sorted(dj["tenants"]) == sorted(dt_["tenants"])

    class Mon:
        def __init__(self):
            self.specs = []

        def add_slo(self, spec):
            self.specs.append(spec)

    mj, mt = Mon(), Mon()
    assert jt.install_slos(mj) == tt.install_slos(mt)
    assert mj.specs == mt.specs


def _micro_order(batcher_cls, tenant_mod, table, tenants=True):
    tenant_mod.set_table(table)
    order, started, release = [], threading.Event(), threading.Event()
    first = {"seen": False}

    def run_batch(rows):
        if not first["seen"]:
            first["seen"] = True
            started.set()
            release.wait(30)
        else:
            order.append(int(rows[0, 0]))
        return rows, rows.shape[0]

    b = batcher_cls(run_batch, max_batch=1, max_wait_ms=1.0)
    try:
        threads = [threading.Thread(target=b.predict, args=(
            numpy.zeros((1, 4), numpy.float32),), kwargs={"tenant": None})]
        threads[0].start()
        assert started.wait(30)
        plan = [(1, "plain"), (2, "plain"), (3, "other"), (4, "gold"),
                (5, "plain"), (6, "gold")]
        for i, tenant in plan:
            t = threading.Thread(target=b.predict, args=(
                numpy.full((1, 4), float(i), numpy.float32),),
                kwargs={"tenant": tenant if tenants else None})
            t.start()
            threads.append(t)
            deadline = time.time() + 30
            while b._queued_rows < i and time.time() < deadline:
                time.sleep(0.001)
        release.set()
        for t in threads:
            t.join(30)
        return order
    finally:
        release.set()
        b.close()
        tenant_mod.set_table(None)


def _table(mod):
    return mod.TenantTable.from_dict({"tenants": {
        "gold": {"priority": "gold"}, "plain": {"priority": "bronze"},
        "other": {"priority": "silver"}}})


def test_micro_batcher_dispatch_order_agrees(tables):
    ref = _micro_order(JaxMicroBatcher, JT, _table(JT))
    port = _micro_order(MicroBatcher, TT, _table(TT))
    assert ref == port
    assert ref.index(4) < ref.index(1)      # gold jumps the backlog
    # no table: the frontend resolves every caller to one tenant
    fifo = _micro_order(MicroBatcher, TT, None, tenants=False)
    assert fifo == [1, 2, 3, 4, 5, 6]


class _Pool:
    """One KV slot."""

    n_slots = 1

    def __init__(self):
        self.free = [0]

    def grant(self):
        return self.free.pop()

    def release(self, slot):
        self.free.append(slot)

    @property
    def free_slots(self):
        return len(self.free)

    @property
    def in_use(self):
        return 1 - len(self.free)

    def nbytes(self):
        return 0


class _Engine:
    """A decode engine stub: prefill and step return token 7; the grant
    order is what the test reads."""

    max_len = 64

    def __init__(self):
        self.pool = _Pool()
        self.prefills = []
        self.gate = threading.Event()
        self.device = None

    def prefill_into(self, slot, prompt, temperature):
        self.prefills.append(prompt[0])
        if prompt[0] == 0:
            self.gate.wait(30)
        return 7

    def step(self, tokens, pos, temp):
        return numpy.full(self.pool.n_slots, 7, numpy.int32)


def _grant_order(batcher_cls, tenant_mod, table, tenants=True):
    tenant_mod.set_table(table)
    engine = _Engine()
    b = batcher_cls(engine, max_queue=16)
    try:
        blocker = b.submit([0], max_tokens=2, tenant="plain")
        deadline = time.time() + 30
        while not engine.prefills and time.time() < deadline:
            time.sleep(0.001)
        handles = [b.submit([i, 1, 2], max_tokens=3,
                            tenant=tenant if tenants else None)
                   for i, tenant in ((1, "plain"), (2, "plain"),
                                     (3, "other"), (4, "gold"))]
        engine.gate.set()
        blocker.wait(30)
        for h in handles:
            h.wait(30)
        return engine.prefills[1:]
    finally:
        engine.gate.set()
        b.close()
        tenant_mod.set_table(None)


def test_continuous_batcher_slot_grants_agree(tables, monkeypatch):
    import veles_torch.serving.decode as TD
    monkeypatch.setattr(TD, "bind_thread", lambda device: None)
    ref = _grant_order(JaxContinuousBatcher, JT, _table(JT))
    port = _grant_order(ContinuousBatcher, TT, _table(TT))
    assert ref == port
    assert ref[0] == 4                      # gold first
    assert _grant_order(ContinuousBatcher, TT, None,
                        tenants=False) == [1, 2, 3, 4]
