"""Workflow factories for the port's master/slave tests: the MNIST chain
of both packages at a small size (784 -> 100 -> 10, minibatch 50, 500 train /
100 valid samples, the reference's ``tests/test_service.py`` size), from
one seed, so a port master or slave and a reference one exchange the
same units under the same names. The port's workflows run on the CPU;
a port master is initialized without a step, as the launcher's master
mode does it."""

import contextlib
import threading
import time

import numpy
import pytest

#: the layers of both packages' MNIST sample (models/mnist.py)
GD = {"learning_rate": 0.02, "weights_decay": 0.0, "gradient_moment": 0.5}
LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
           "<-": dict(GD)},
          {"type": "softmax", "->": {"output_sample_shape": 10},
           "<-": dict(GD)}]
SIZES = dict(minibatch_size=50, n_train=500, n_valid=100)
SEED = 555
#: every wait of these tests is bounded by this many seconds
BOUND = 120.0


def port_wf(name, role=None, max_epochs=2, shuffle=True, seed=SEED,
            sizes=SIZES):
    """The port's MNIST chain on the CPU, initialized; ``role`` "master"
    builds no step."""
    import veles_torch.prng as tprng
    from veles_torch.znicz.models.mnist import MnistLoader
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    tprng.seed_all(seed)
    wf = StandardWorkflow(
        name=name, layers=[dict(layer) for layer in LAYERS],
        loader_factory=lambda w: MnistLoader(
            w, name="loader", minibatch_size=sizes["minibatch_size"],
            n_train=sizes["n_train"], n_valid=sizes["n_valid"],
            shuffle=shuffle),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50})
    return wf.initialize(device="cpu", with_step=role != "master")


def ref_wf(name, backend="numpy", slave=False, max_epochs=2, shuffle=True,
           seed=SEED, sizes=SIZES):
    """The reference's MNIST chain on ``backend`` ("numpy", or "cpu": the
    fused step, per-step on a slave), initialized."""
    import veles.prng as jprng
    from veles.znicz_tpu.models.mnist import MnistLoader
    from veles.znicz_tpu.standard_workflow import StandardWorkflow
    jprng.seed_all(seed)
    wf = StandardWorkflow(
        None, name=name, layers=[dict(layer) for layer in LAYERS],
        loader_factory=lambda w: MnistLoader(
            w, name="loader", minibatch_size=sizes["minibatch_size"],
            n_train=sizes["n_train"], n_valid=sizes["n_valid"],
            shuffle=shuffle),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50})
    wf.is_slave = slave
    wf.initialize(device=backend)
    return wf


def port_weights(wf):
    """{unit: {param: ndarray}} of a port workflow's forwards."""
    return {f.name: {k: t.detach().cpu().numpy().copy()
                     for k, t in f.export_params().items()}
            for f in wf.forwards}


def ref_weights(wf):
    """{unit: {param: ndarray}} of a reference workflow's forwards."""
    return {f.name: {k: numpy.array(getattr(f, k).map_read().mem)
                     for k in ("weights", "bias")}
            for f in wf.forwards}


def max_diff(a, b):
    """The largest absolute difference between two weight trees of the
    same units and keys."""
    assert set(a) == set(b), (sorted(a), sorted(b))
    return max(float(numpy.abs(a[u][k] - b[u][k]).max())
               for u in a for k in a[u])


def run_thread(fn, *args):
    """Start ``fn(*args)`` on a daemon thread; -> (thread, result list,
    error list)."""
    out, errors = [], []

    def body():
        try:
            out.append(fn(*args))
        except BaseException as exc:     # surfaced by the test
            errors.append(exc)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    return t, out, errors


def join_all(threads, bound=BOUND):
    """Join every thread within ``bound`` seconds in all; -> the ones
    still alive."""
    deadline = time.monotonic() + bound
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    return [t for t in threads if t.is_alive()]


@contextlib.contextmanager
def serving(server):
    """Serve ``server`` (either package's MasterServer) on a thread; on
    exit stop it and wait for its thread."""
    thread = server.start_background()
    try:
        yield "127.0.0.1:%d" % server.bound_address[1]
    finally:
        server.done.set()
        server.request_stop()
        thread.join(timeout=BOUND)


@pytest.fixture(scope="module", autouse=True)
def close_process_planes():
    """After a module of wire tests (a test module takes this by importing
    it): close the port's process-global health monitor and stop both
    packages' process-global reactors, which the masters and dashboards
    started; their threads would otherwise write into whatever registry
    a later test of this process makes active. The next
    ``get_reactor()`` / ``get_monitor()`` makes fresh ones."""
    yield
    import veles.reactor as JR
    import veles_torch.health as TH
    import veles_torch.reactor as TR
    previous = TH.set_monitor(None)
    if previous is not None:
        previous.close()
    for reactor in (TR, JR):
        previous = reactor.set_reactor(None)
        if previous is not None:
            previous.stop()
