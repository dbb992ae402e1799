"""The port's expert parallelism and its MoE under every axis
(veles_torch/znicz/ops/moe.py, veles_torch/znicz/parallel/expert.py, set up
from ``root.lm.parallel`` alone) against the JAX package's same config on
its 8-device virtual CPU mesh, after tests/test_moe.py: the MoE LM under
``expert`` 4 and ``expert`` 2 × ``data`` 2 with gather routing, and
``expert`` 4, 2 × ``data`` 2, 2 × ``seq`` 2 and 2 × ``model`` 2 with the
all-to-all exchange, each within 1e-5 of the reference after one epoch
(every parameter, its solver state, the validation history) with the
exact collectives of a train step; the all-to-all's per-shard quota drops
the reference's tokens, token for token; an MoE under ``data``, ``seq``
and ``model`` 2 equals the reference and the port's one-process run with
its drops equal; an EP checkpoint holds the full tensors and restores
into the reference, onto one device and back onto the mesh; a skipped
combine all-reduce reads above ``chip_smoke.py``'s movement bar. The
ranks are gloo processes (groups of 2 and 4) spawned once for the
module (tests/torch_parallel_workers.py)."""

import os

import jax
import numpy
import pytest

import veles.prng as jprng
from veles.config import root as jroot
from veles.snapshotter import load_snapshot as jload_snapshot
from veles.znicz_tpu import parallel as jpar
from veles.znicz_tpu.models import transformer_lm as jlm
from veles.znicz_tpu.parallel import expert as jexpert
from veles_torch.snapshotter import load_snapshot
from tests.torch_parallel_workers import RankGroup

LOADER = {"minibatch_size": 16, "n_train": 128, "n_valid": 32,
          "seq_len": 16, "vocab": 8, "max_period": 4}
MODEL = {"dim": 32, "heads": 2, "layers": 1, "ffn_hidden": 64,
         "attn_block": None, "attn_impl": None, "moe_experts": 4,
         "moe_capacity_factor": 2.0, "moe_aux_weight": 0.01,
         "stacked": False}
SEED = 515
#: one epoch (8 train steps) against the reference's same mode
#: (observed ≤ 1.2e-7)
ATOL = 1e-5
NO_AXES = {"seq": 1, "model": 1, "data": 1, "expert": 1, "pipe": 1,
           "ep_routing": "gather"}


@pytest.fixture(scope="module")
def groups():
    made = {}

    def get(n):
        if n not in made:
            made[n] = RankGroup(n)
        return made[n]
    yield get
    for g in made.values():
        g.close()


def config(parallel, epochs=1, cf=None):
    model = MODEL if cf is None else dict(MODEL, moe_capacity_factor=cf)
    return {"loader": LOADER, "model": model,
            "decision": {"max_epochs": epochs},
            "parallel": dict(NO_AXES, **parallel)}


def run_reference(parallel, cf=None):
    saved = jroot.lm.to_dict()
    try:
        for section, values in config(parallel, cf=cf).items():
            getattr(jroot.lm, section).update(values)
        jprng.seed_all(SEED)
        wf = jlm.create_workflow(name="TorchLMParallel")
        wf.initialize(device="cpu")
        wf.run()
        wf.xla_step.sync_host()
        return wf
    finally:
        jroot.lm.update(saved)


def assert_close_to(wf, port):
    want = {u.name: {**u.export_params(), **u.export_state()}
            for u in wf.forwards + wf.gds}
    got = {**port["params"], **port["state"]}
    for unit, sub in want.items():
        for key, value in sub.items():
            err = numpy.abs(numpy.asarray(got[unit][key], numpy.float64)
                            - numpy.asarray(value, numpy.float64)).max()
            assert err <= ATOL, (unit, key, err)
    hist_w = [h["validation"]["metric"] for h in wf.decision.history]
    hist_g = [h["validation"]["metric"] for h in port["history"]]
    assert numpy.allclose(hist_g, hist_w, rtol=0, atol=ATOL), \
        (hist_g, hist_w)


def expected_counts(parallel):
    """The collectives of one train step (1 MoE layer, stats not due)."""
    axes = {k: v for k, v in parallel.items()
            if k in ("data", "seq", "model", "expert") and v > 1}
    seq, data, model = (axes.get(k, 1) for k in ("seq", "data", "model"))
    want = {}
    if seq > 1:                      # the ring (tests/test_torch_lm_parallel)
        want["collective-permute"] = 2 * (seq - 1) + 4 * (seq - 1) + 2
    reduces = 1 if seq * data * axes.get("expert", 1) > 1 else 0  # bucket
    if model > 1:                    # TP of the attention, forward and back
        reduces += 2
    if parallel.get("ep_routing") == "alltoall":
        # the exchange and its reverse, forward and backward; under seq
        # the reshard of x and y forward, of err and dx backward; under
        # model the gathers of y and dx; the global frequency; the
        # experts' own bucket (every axis but expert) where it is not
        # empty, and the router's (every axis) where TP keeps model out of
        # the step's
        want["all-to-all"] = 4 + (4 if seq > 1 else 0)
        reduces += 1 + (1 if seq * data * model > 1 else 0) \
            + (1 if model > 1 else 0)
        if model > 1:
            want["all-gather"] = 2
    else:
        # the expert line's tokens and errors gathered, the counts over
        # data/seq; the combine, the input and gate gradients; the
        # experts' bucket over data/seq
        want["all-gather"] = 2 + (1 if seq * data > 1 else 0)
        reduces += 2 + (1 if seq * data > 1 else 0)
    want["all-reduce"] = reduces
    return want


#: (root.lm.parallel, the model's capacity factor)
MODES = [
    ({"expert": 4}, 2.0),
    ({"expert": 2, "data": 2}, 2.0),
    ({"expert": 4, "ep_routing": "alltoall"}, 2.0),
    ({"expert": 2, "data": 2, "ep_routing": "alltoall"}, 2.0),
    ({"expert": 2, "seq": 2, "ep_routing": "alltoall"}, 2.0),
    ({"expert": 2, "model": 2, "ep_routing": "alltoall"}, 8.0),
]


@pytest.mark.parametrize("parallel,cf", MODES,
                         ids=[str(m) for m, _ in MODES])
def test_ep_lm_matches_reference(groups, parallel, cf):
    """Every rank ends the epoch with the same gathered state, within 1e-5
    of the reference's same mode: the gather mode's global quota and the
    all-to-all's per-source-shard quota alike (at cf 2.0 both drop tokens;
    the model case at cf 8.0, where no shard overflows, as the
    reference's own composition test); the collectives of a train step
    exactly, the all-to-all's without an all-gather."""
    n = int(numpy.prod([v for k, v in parallel.items()
                        if k != "ep_routing"]))
    res = groups(n).run("lm_run", config(parallel, cf=cf), SEED)
    for r in res[1:]:
        assert r["history"] == res[0]["history"]
    assert_close_to(run_reference(parallel, cf), res[0])
    counts = res[0]["counts"]
    assert counts == expected_counts(parallel), counts
    if set(parallel) == {"expert", "ep_routing"}:
        # the exchange moves each source shard's (E, C, D) f32 slots 4
        # times a layer: b' = 16/n rows of S 16, C = ceil(cf·b'·S/E)
        n = parallel["expert"]
        slots = 4 * -(-int(cf * (16 // n) * 16) // 4) * 32 * 4
        assert res[0]["step_bytes"]["all-to-all"] == 4 * slots, \
            res[0]["step_bytes"]


def test_ep_alltoall_overflow_drop_pattern(groups):
    """After tests/test_moe.py's: a constructed routing on a 4-shard expert
    mesh where the per-shard quota (1) and the global one (2) part both
    ways; the port's exchange keeps and drops the reference's tokens,
    token for token, and its outputs are the reference's."""
    e = d = 4
    b, s, h = 4, 4, 8
    route = numpy.array([[0, 1, 1, 2], [0, 2, 2, 3], [0, 3, 3, 2],
                         [0, 1, 3, 2]], numpy.int32)
    x = numpy.zeros((b, s, d), numpy.float32)
    for i in range(b):
        for j in range(s):
            x[i, j, route[i, j]] = 5.0
    gen = numpy.random.default_rng(77)
    params = {"router": numpy.eye(d, e, dtype=numpy.float32),
              "weights": gen.normal(0, 0.3, (e, d, h)).astype(numpy.float32),
              "bias": numpy.zeros((e, h), numpy.float32),
              "weights2": gen.normal(0, 0.3, (e, h, d)).astype(
                  numpy.float32),
              "bias2": numpy.zeros((e, d), numpy.float32)}
    cf = 0.5

    class _Unit:
        experts = e
        ACTIVATION = "strict_relu"
        residual = False
        ep_mesh = jpar.make_mesh({"expert": e}, jax.devices("cpu")[:e])
        ep_axis = "expert"
        ep_batch_axes = ()

        @staticmethod
        def capacity(n_tokens):
            return max(1, int(numpy.ceil(cf * n_tokens / e)))

    import jax.numpy as jnp
    y_ref, cache = jexpert.moe_a2a_fwd(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        _Unit, lambda spec, *ops: jnp.einsum(spec, *ops))
    kept_ref = numpy.asarray(cache["dispatch"]).sum(axis=(-1, -2)) > 0.5
    res = groups(4).run("a2a_shard", (("expert", 4),), x, params, cf)
    kept = numpy.concatenate([k for _, k in res])
    y = numpy.concatenate([v for v, _ in res])
    assert numpy.array_equal(kept, kept_ref.reshape(b, s))
    assert numpy.abs(y - numpy.asarray(y_ref).reshape(y.shape)).max() \
        <= 1e-6
    # the one global quota (2 a expert) keeps another set, both ways
    counts, kept_glob = {}, []
    for ex in route.reshape(-1):
        kept_glob.append(counts.get(ex, 0) < 2)
        counts[ex] = counts.get(ex, 0) + 1
    kept_glob = numpy.array(kept_glob).reshape(b, s)
    assert numpy.any(kept & ~kept_glob) and numpy.any(~kept & kept_glob)


@pytest.mark.parametrize("axis", ["data", "seq", "model"])
def test_moe_under_an_axis_routes_globally(groups, axis):
    """An MoE FFN under ``data``, ``seq`` or ``model`` 2 routes every token
    of the minibatch under the one global quota: the port's run equals
    the reference's same config and the port's one-process run within
    1e-5, and every rank's last forward dropped the one-process run's
    count of tokens."""
    res = groups(2).run("lm_run", config({axis: 2}), SEED)
    assert_close_to(run_reference({axis: 2}), res[0])
    one = groups(2).run("lm_run", config({}), SEED)[0]
    assert one["dropped"] and all(v > 0 for v in one["dropped"].values())
    for r in res:
        assert r["dropped"] == one["dropped"], (r["dropped"],
                                                one["dropped"])
        for unit, sub in one["params"].items():
            for key, value in sub.items():
                assert numpy.abs(r["params"][unit][key] - value).max() \
                    <= ATOL, (axis, unit, key)


def test_ep_checkpoint_holds_full_tensors(groups, tmp_path):
    """After tests/test_moe.py's snapshot case: an ``expert`` 2 × ``data``
    2 all-to-all run writes (rank 0 only) checkpoints with the FULL expert
    tensors and solver state and an inference archive with the full
    tensors; the reference restores the checkpoint bit for bit onto one
    device; the port resumes it onto one device and back onto the mesh,
    both ending the epoch within 1e-5 of the mesh run (at cf 8.0, where no
    shard overflows its quota, as the reference's case)."""
    parallel = {"expert": 2, "data": 2, "ep_routing": "alltoall"}
    cfg = config(parallel, cf=8.0)
    snaps = str(tmp_path / "ep")
    archive = str(tmp_path / "archive")
    res = groups(4).run("lm_run", cfg, SEED, snaps, None, archive)
    path = res[0]["destination"]
    assert path and os.path.exists(path)
    assert all(r["destination"] is None for r in res[1:])
    state = load_snapshot(path)
    moe = next(n for n in state["params"] if "moe" in n.lower())
    assert state["params"][moe]["weights"].shape == (4, 32, 64)
    gd = next(n for n in state["state"] if "vel_weights" in
              state["state"][n] and state["state"][n]["vel_weights"].ndim
              == 3)
    assert state["state"][gd]["vel_weights"].shape == (4, 32, 64)
    saved = jroot.lm.to_dict()
    try:
        for section, values in config({}, cf=8.0).items():
            getattr(jroot.lm, section).update(values)
        jprng.seed_all(SEED)
        jw = jlm.create_workflow(name="TorchLMParallel")
        jw.initialize(device="cpu")
        jw.restore_state(jload_snapshot(path))
        jw.xla_step.sync_host()
    finally:
        jroot.lm.update(saved)
    for f in jw.forwards:
        for key, value in f.export_params().items():
            assert numpy.array_equal(numpy.asarray(value),
                                     state["params"][f.name][key])
    import json
    with open(res[0]["archive"]) as f:
        doc = json.load(f)
    unit = next(u for u in doc["units"] if u["name"] == moe)
    for key, value in res[0]["params"][moe].items():
        arr = numpy.load(os.path.join(archive, unit[key]))
        assert arr.shape == value.shape and numpy.array_equal(arr, value)
    one = groups(2).run("lm_run", config({}, cf=8.0), SEED, None, path)[0]
    again = groups(4).run("lm_run", cfg, SEED, None, path)[0]
    for got in (one, again):
        for unit, sub in res[0]["params"].items():
            for key, value in sub.items():
                err = numpy.abs(got["params"][unit][key] - value).max()
                assert err <= ATOL, (unit, key, err)


def test_movement_bar_sees_a_skipped_combine(groups):
    """``chip_smoke.py`` holds the card's EP runs against one process by
    each tensor's movement (``PARALLEL_DP_RTOL``, f32). A gather-mode run
    whose ranks skip the combine all-reduce (each keeps its own experts'
    outputs) must read well above that bar, the sound run far below."""
    import chip_smoke
    import veles_torch.prng as tprng
    from veles_torch.config import root as troot
    from veles_torch.znicz.models import transformer_lm as tlm
    parallel = {"expert": 2}
    saved = troot.lm.to_dict()
    try:
        for section, values in config({}).items():
            getattr(troot.lm, section).update(values)
        tprng.seed_all(SEED)
        fresh = tlm.create_workflow(name="TorchLMParallel")
        fresh.initialize(device="cpu")
        start = fresh.checkpoint_state()["params"]
    finally:
        troot.lm.update(saved)
    one = groups(2).run("lm_run", config({}), SEED)[0]

    def worst(got):
        out = 0.0
        for unit, sub in one["params"].items():
            for key, value in sub.items():
                moved = numpy.abs(value - start[unit][key]).max()
                out = max(out, numpy.abs(got[unit][key] - value).max()
                          / max(moved, 1e-30))
        return out
    sound = worst(groups(2).run("lm_run", config(parallel), SEED)[0]
                  ["params"])
    broken = worst(groups(2).run("lm_run_fault", config(parallel), SEED,
                                 "combine")[0]["params"])
    bar = chip_smoke.PARALLEL_DP_RTOL
    assert sound < 1e-3 * bar, (sound, broken)
    assert broken > 2 * bar, (sound, broken)
