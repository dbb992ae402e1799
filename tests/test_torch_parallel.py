"""The port's distribution layer (veles_torch/znicz/parallel) on gloo ranks
of this host against the JAX package on its 8-device virtual CPU mesh
(tests/conftest.py): the mesh layout, ``grad_sync_bytes``,
``init_multihost``'s plumbing, ring attention forward and backward on 2
and 4 ranks (every inner block, causal and not), MNIST data parallelism
on 4 ranks and CIFAR's with a minibatch the ranks do not divide, and the
collectives each mode issues. Same numpy inputs and seeds in both
packages; the ranks run in one group of 4 processes spawned once for the
module (tests/torch_parallel_workers.py)."""

import jax
import numpy
import pytest

import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu import parallel as jpar
from veles.znicz_tpu.parallel import ring as jring
from veles_torch.config import root as troot
from veles_torch.znicz import parallel as tpar
from tests.torch_parallel_workers import RankGroup

#: ring outputs, lse and gradients, port vs reference (observed ≤ 1.2e-6)
RING_ATOL = 1e-5
#: MNIST parameters after 3 epochs of DP (observed ≤ 2e-7)
MNIST_ATOL = 1e-5


@pytest.fixture(scope="module")
def group4():
    group = RankGroup(4)
    yield group
    group.close()


def test_mesh_layout():
    """``numpy.array(ranks).reshape(sizes)``: coordinates, lines and
    indices of every rank of a data × seq × model mesh."""
    m = tpar.Mesh({"data": 2, "seq": 2, "model": 2}, rank=5)
    assert m.grid.tolist() == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert m.coords == {"data": 1, "seq": 0, "model": 1}
    assert m.line("model") == [4, 5]
    assert m.line("seq") == [5, 7]
    assert m.line(("data", "seq")) == [1, 3, 5, 7]
    assert m.line(("seq", "data")) == [1, 3, 5, 7]
    assert m.index(("data", "seq")) == 2
    assert m.index("model", rank=6) == 0
    assert m.lines("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.axis_size(("data", "model", "pipe")) == 4
    assert tpar.batch_sharding(m).spec == ("data",)
    assert tpar.replicated(m).spec == ()


def test_shard_specs_round_trip():
    """A fused q|k|v column shard keeps each rank's columns of all three
    sections; the shards reassemble bit for bit."""
    import torch
    full = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    spec = tpar.ShardSpec(1, 3)
    parts = [tpar.shard_of(full, spec, 2, r) for r in range(2)]
    assert parts[0][0].tolist() == [0, 1, 4, 5, 8, 9]
    assert torch.equal(tpar.unshard(parts, spec), full)


def test_grad_sync_bytes():
    """The reference's case, and the same tree as torch tensors."""
    import torch
    params = {"layer": {"w": numpy.zeros((784, 100), numpy.float32),
                        "b": numpy.zeros(100, numpy.float32)}}
    want = (784 * 100 + 100) * 4
    assert tpar.grad_sync_bytes(params) == want
    assert jpar.grad_sync_bytes(params) == want
    assert tpar.grad_sync_bytes(
        {"layer": {k: torch.from_numpy(v) for k, v in
                   params["layer"].items()}}) == want


def test_init_multihost_arg_plumbing(monkeypatch):
    """After tests/test_parallel.py's: the address, world size and rank
    reach ``init_process_group``; with none, the torchrun environment
    (``env://``) does; the transport picks the backend."""
    import torch.distributed as dist
    from veles_torch.znicz.parallel import collectives
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(collectives, "_transport", None)
    rank, count = tpar.init_multihost("10.0.0.1:1234", 8, 3)
    got = dict(calls[-1])
    got.pop("timeout")
    assert got == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                   "world_size": 8, "rank": 3}
    assert (rank, count) == (3, 8)
    assert collectives.transport() == "gloo"
    tpar.init_multihost(transport="nccl")
    got = dict(calls[-1])
    got.pop("timeout")
    assert got == {"backend": "nccl", "init_method": "env://"}
    assert collectives.transport() == "nccl"
    with pytest.raises(ValueError, match="transport must be one of"):
        tpar.init_multihost(transport="mpi")


def test_unported_setups_name_item_10c():
    with pytest.raises(NotImplementedError, match="item 10c"):
        tpar.setup_expert_parallel(None, None)
    with pytest.raises(NotImplementedError, match="item 10c"):
        tpar.setup_pipeline_parallel(None, None)


@pytest.mark.parametrize("axis", ["data", "seq"])
def test_dropout_under_a_sharded_axis_is_refused(axis):
    """Each rank would draw the same dropout mask for its own rows (or
    positions), not one mask over the minibatch: refused, naming item
    10c, before the mesh is attached."""
    from veles_torch.znicz.models.mnist import MnistLoader
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
              {"type": "dropout", "->": {"dropout_ratio": 0.5}},
              {"type": "softmax", "->": {"output_sample_shape": 10}}]
    wf = StandardWorkflow(
        name="DropoutDP", layers=layers,
        loader_factory=lambda w: MnistLoader(
            w, name="loader", minibatch_size=8, n_train=16, n_valid=8),
        decision_config={"max_epochs": 1})
    wf.initialize(device="cpu")
    mesh = tpar.Mesh({axis: 2}, rank=0)
    setup = {"data": tpar.setup_data_parallel,
             "seq": tpar.setup_sequence_parallel}[axis]
    with pytest.raises(NotImplementedError,
                       match=r"dropout unit .* %r axis.*item 10c" % axis):
        setup(wf, mesh)
    assert wf.mesh is None


def _ring_inputs(seed=4242, shape=(1, 2, 16, 8)):
    gen = numpy.random.default_rng(seed)
    return [gen.normal(0.0, 1.0, shape).astype(numpy.float32)
            for _ in range(4)]


def _ring_reference(n, q, k, v, dout, causal, inner):
    mesh = jpar.make_mesh({"seq": n}, jax.devices()[:n])
    out, lse = jax.jit(lambda a, b, c: jring.ring_self_attention(
        a, b, c, mesh, causal=causal, inner=inner, block=2))(q, k, v)
    grads = jax.jit(lambda a, b, c, o, l, d: jring.ring_self_attention_bwd(
        a, b, c, o, l, d, mesh, causal=causal, inner=inner,
        block=2))(q, k, v, out, lse, dout)
    return [numpy.asarray(t) for t in (out, lse) + tuple(grads)]


@pytest.mark.parametrize("inner", [None, "scan", "pallas"],
                         ids=["dense", "scan", "kernel"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_reference(group4, n, causal, inner):
    """``ring_self_attention(_bwd)`` on the ranks' shards against the
    reference's on its virtual mesh, at 1e-5: out, lse, dq, dk, dv. Inner
    ``"pallas"`` is the port's plain flash version here (the kernels on
    the card), the reference's Pallas kernels in interpret mode. Each
    forward hops (k, v) n−1 times: 2(n−1) collective-permutes; the
    backward 4(n−1) + 2."""
    q, k, v, dout = _ring_inputs()
    axes = (("seq", 4),) if n == 4 else (("data", 2), ("seq", 2))
    res = group4.run("ring", axes, q, k, v, dout, causal, inner, 2)
    want = _ring_reference(n, q, k, v, dout, causal, inner)
    # ranks 0..n-1 hold the seq shards of one ring, in order
    got = [numpy.concatenate([res[r][0][i] for r in range(n)], axis=2)
           for i in range(5)]
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        err = numpy.abs(g - w).max()
        assert err <= RING_ATOL, (name, err)
    for _, fwd, bwd in res:
        assert fwd == {"collective-permute": 2 * (n - 1)}
        assert bwd == {"collective-permute": 4 * (n - 1) + 2}


MNIST_LOADER = {"minibatch_size": 64, "n_train": 512, "n_valid": 128}


def _jax_mnist_dp(n, epochs, seed):
    from veles.znicz_tpu.models import mnist as jmnist
    saved = jroot.mnist.to_dict()
    try:
        jroot.mnist.loader.update(MNIST_LOADER)
        jroot.mnist.decision.max_epochs = epochs
        jprng.seed_all(seed)
        wf = jmnist.create_workflow(name="JaxMnistDP")
        wf.initialize(device="cpu")
        jpar.setup_data_parallel(
            wf, jpar.make_mesh({"data": n}, jax.devices()[:n]))
        wf.run()
        wf.xla_step.sync_host()
        return wf
    finally:
        jroot.mnist.update(saved)


def test_mnist_data_parallel_matches_reference(group4):
    """MNIST on 4 data ranks (512/128, mb 64, 3 epochs) against the
    reference's DP on 4 virtual devices: every parameter within 1e-5,
    the validation history within 1e-5; one gradient all-reduce a train
    step."""
    import veles_torch.znicz.models.mnist  # noqa: F401 (root.mnist)
    res = group4.run("sample_dp", "mnist", MNIST_LOADER, 3, 99,
                     (("data", 4),))
    jw = _jax_mnist_dp(4, 3, 99)
    port = res[0]
    for r in res[1:]:
        assert r["history"] == port["history"]
    for f in jw.forwards:
        for key, value in f.export_params().items():
            err = numpy.abs(port["params"][f.name][key] - value).max()
            assert err <= MNIST_ATOL, (f.name, key, err)
    want = [h["validation"]["metric"] for h in jw.decision.history]
    got = [h["validation"]["metric"] for h in port["history"]]
    assert numpy.allclose(got, want, rtol=0, atol=MNIST_ATOL), (got, want)
    assert port["counts"] == {"all-reduce": 1}


def test_cifar_data_parallel_non_divisible_minibatch(group4):
    """After tests/test_parallel.py's conv case: CIFAR with minibatch 10
    on 4 data ranks pads each minibatch to 12 (3 rows a rank, the padding
    masked); the run completes and its validation error equals a
    one-process run's of the same seed within 1e-6 (the padded rows
    change nothing)."""
    import veles_torch.prng as tprng
    from veles_torch.znicz.models import cifar10 as tcifar
    loader = {"minibatch_size": 10, "n_train": 40, "n_valid": 20}
    res = group4.run("sample_dp", "cifar10", loader, 1, 7, (("data", 4),))
    saved = troot.cifar.to_dict()
    try:
        troot.cifar.loader.update(loader)
        troot.cifar.decision.max_epochs = 1
        tprng.seed_all(7)
        one = tcifar.create_workflow().initialize(device="cpu").run()
    finally:
        troot.cifar.update(saved)
    assert res[0]["history"], "no epochs completed"
    got = res[0]["history"][-1]["validation"]
    want = one.decision.history[-1]["validation"]
    assert got["samples"] == want["samples"] == 20
    assert abs(got["metric"] - want["metric"]) <= 1e-6, (got, want)
    assert res[0]["counts"] == {"all-reduce": 1}


def test_failing_rank_fails_the_run_and_tears_down():
    """``parallel.spawn``: a rank that raises fails the run with its error
    text; the rank left waiting in a collective is torn down within the
    bounded grace time, not left to the group's timeout."""
    import time
    from tests.torch_parallel_workers import fail_on_rank_one
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*rank one gives up"):
        tpar.spawn(fail_on_rank_one, 2, grace_s=5.0, timeout_s=120.0)
    assert time.monotonic() - t0 < 60.0


def test_dryrun_multichip_two_ranks():
    """``graft_entry.dryrun_multichip(2)``: MNIST under DP, the LM under
    DP × TP and the ring (dense and scan inner blocks), one train step
    each, every leg with the collectives it must issue; the reference's
    EP and PP legs listed as item 10c. The CPU is asked for: the card is
    the default."""
    from veles_torch.graft_entry import dryrun_multichip
    report = dryrun_multichip(2, device="cpu")
    legs = report["legs"]
    assert sorted(legs) == ["DryrunDP", "DryrunRing", "DryrunRingFlash",
                            "DryrunTP"]
    assert legs["DryrunDP"]["collectives"] == {"all-reduce": 1}
    assert legs["DryrunTP"]["mesh"] == {"model": 2}
    assert legs["DryrunTP"]["collectives"]["all-reduce"] >= 4
    for ring in ("DryrunRing", "DryrunRingFlash"):
        assert legs[ring]["collectives"]["collective-permute"] == 8
    assert report["transport"] == "gloo"
    assert all("item 10c" in v for v in report["not_run"].values())


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """Called as the reference's is, the dry run asks for the card over
    NCCL: without a CUDA device, or with fewer cards than ranks, it
    refuses before any rank is spawned; a CPU run takes gloo only."""
    import torch
    from veles_torch import graft_entry
    monkeypatch.setattr(graft_entry, "_dryrun_rank", None)  # never reached
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device.*-d cpu"):
        graft_entry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl needs one card per rank"):
        graft_entry.dryrun_multichip(2)
    assert tpar.declared_transport("cuda", "gloo-host", 2) == "gloo-host"
    assert tpar.declared_transport("cpu", None, 2) == "gloo"
    with pytest.raises(ValueError, match="-d cpu ranks take gloo"):
        graft_entry.dryrun_multichip(2, device="cpu", transport="nccl")
