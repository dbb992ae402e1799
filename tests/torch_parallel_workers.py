"""Rank processes of the port's parallel tests: a group of gloo ranks on
``tcp://localhost`` (the port's counterpart of the reference's 8-device
virtual CPU mesh), spawned once per test module and fed tasks by name.

A spawned rank imports this light module, never a test module (which
imports the JAX package). Each rank runs one torch thread; every wait is
bounded.
"""

import contextlib
import multiprocessing
import os
import queue
import time
import traceback

#: seconds a task may take on a rank before the test fails it
TASK_TIMEOUT_S = 120.0

#: the meshes made in this rank, by their axes
_MESHES = {}


class RankGroup:
    """``world`` rank processes in one gloo process group; :meth:`run`
    hands every rank the same task and returns their results by rank."""

    def __init__(self, world, start_timeout_s=60.0):
        from veles_torch.znicz.parallel import free_port
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        port = free_port()
        self.procs = [ctx.Process(target=serve, daemon=True,
                                  args=(r, world, port, self.tasks[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.run("ready", timeout_s=start_timeout_s)

    def run(self, name, *args, timeout_s=TASK_TIMEOUT_S):
        """``name(*args)`` on every rank -> [result of rank r]; a rank's
        error or a timeout raises (and closes the group)."""
        for q in self.tasks:
            q.put((name, args))
        got, deadline = {}, time.monotonic() + timeout_s
        while len(got) < self.world:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = self.results.get(timeout=max(0.1, left))
            except queue.Empty:
                self.close()
                raise TimeoutError("task %s: ranks %s did not answer in "
                                   "%.0f s" % (name, sorted(
                                       set(range(self.world)) - set(got)),
                                       timeout_s))
            if not ok:
                self.close()
                raise RuntimeError("task %s failed on rank %d:\n%s"
                                   % (name, rank, value))
            got[rank] = value
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        stop = time.monotonic() + 10.0
        for p in self.procs:
            p.join(max(0.0, stop - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()


def serve(rank, world, port, tasks, results):
    """A rank's loop: join the group, then run each task by name."""
    import torch
    torch.set_num_threads(1)
    from veles_torch.znicz import parallel
    parallel.init_multihost("127.0.0.1:%d" % port, world, rank,
                            transport="gloo", timeout_s=TASK_TIMEOUT_S)
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args = task
        try:
            results.put((rank, True, globals()[name](*args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()
    os._exit(0)


def mesh(axes):
    """The mesh of ``axes`` (a tuple of (name, size)), made once."""
    from veles_torch.znicz import parallel
    if axes not in _MESHES:
        _MESHES[axes] = parallel.make_mesh(dict(axes))
    return _MESHES[axes]


def ready():
    import torch.distributed as dist
    return dist.get_rank()


def ring(axes, q, k, v, dout, causal, inner, block):
    """The port's ring forward and backward on this rank's ``seq`` shard
    of the global (B, H, S, dh) numpy inputs -> its shards of (out, lse,
    dq, dk, dv) and the collectives each pass issued."""
    import torch
    from veles_torch.znicz.parallel import collectives as C
    from veles_torch.znicz.parallel import ring as R
    m = mesh(axes)
    n, r = m.shape["seq"], m.index("seq")
    s = q.shape[2] // n

    def mine(a):
        return torch.from_numpy(a[:, :, r * s:(r + 1) * s].copy())

    counts = {}
    with C.step_window(counts):
        out, lse = R.ring_self_attention(
            mine(q), mine(k), mine(v), m, causal=causal, inner=inner,
            block=block)
    fwd = dict(counts)
    with C.step_window(counts):
        grads = R.ring_self_attention_bwd(
            mine(q), mine(k), mine(v), out, lse, mine(dout), m,
            causal=causal, inner=inner, block=block)
    return ([t.numpy() for t in (out, lse) + tuple(grads)], fwd,
            dict(counts))


def lm_run(config, seed, snapshots=None, restore=None, archive=None):
    """Train the port's LM of ``config`` ({root.lm section: values}) on
    this group's mesh -> (history, full params and state, the last train
    step's collectives, where the mesh put this rank); every rank takes
    part in the checkpoint's gathers. ``snapshots``: a directory rank 0
    writes its checkpoints to; ``restore``: a checkpoint to resume
    from; ``archive``: a directory rank 0 writes the inference archive
    to (every rank takes part in its gathers)."""
    import veles_torch.prng as prng
    from veles_torch.config import root
    from veles_torch.snapshotter import load_snapshot
    from veles_torch.znicz import parallel
    from veles_torch.znicz.models import transformer_lm as tlm
    from veles_torch.znicz.parallel import pipeline
    saved = root.lm.to_dict()
    try:
        for section, values in config.items():
            getattr(root.lm, section).update(values)
        pipeline.counts.clear()
        prng.seed_all(seed)
        wf = tlm.create_workflow(name="TorchLMParallel")
        if snapshots:
            wf.link_snapshotter(directory=snapshots, prefix="lmpar")
        wf.initialize(device="cpu")
        if restore:
            wf.restore_state(load_snapshot(restore))
        wf.run()
        written = wf.export_inference(archive) if archive else None
        tree = wf.checkpoint_state()
        return {"history": wf.decision.history, "archive": written,
                "params": tree["params"], "state": tree["state"],
                "counts": parallel.collective_counts(wf.step),
                "step_bytes": dict(wf.step.collective_bytes),
                "dropped": {f.name: float(f.dropped) for f in wf.forwards
                            if getattr(f, "dropped", None) is not None},
                "chunks": dict(pipeline.counts),
                "steps": (wf.step.train_steps, wf.step.eval_steps),
                "mesh": None if wf.mesh is None else dict(wf.mesh.shape),
                "coords": None if wf.mesh is None else wf.mesh.coords,
                "destination": wf.snapshotter.destination
                if wf.snapshotter is not None else None}
    finally:
        root.lm.update(saved)


@contextlib.contextmanager
def planted(fault):
    """A fault planted in the port for the block's duration: ``"grad"``
    skips the gradient buckets' all-reduces, ``"tp"`` the all-reduces of
    TP's partial sums and input gradients, ``"combine"`` the gather-mode
    MoE's combine all-reduce (each rank keeps its experts' partial
    outputs), ``"hop"`` the pipeline's backward hop of microbatch 0 (both
    sides skip it: the receiving stage takes zeros)."""
    import torch
    from veles_torch.znicz import step as S
    from veles_torch.znicz.ops import attention as A
    from veles_torch.znicz.ops import moe as M
    from veles_torch.znicz.parallel import pipeline as PL
    saved = S.flush_deferred, A.tp_sum, M.combine_sum, PL.stage_hop
    if fault == "grad":
        S.flush_deferred = lambda entries, reduce: saved[0](
            entries, lambda flat, axes: flat)
    elif fault == "tp":
        A.tp_sum = lambda unit, t: t
    elif fault == "combine":
        M.combine_sum = lambda unit, t: t
    elif fault == "hop":
        def hop(mesh, axis, sends, recvs):
            sends = [x for x in sends if not (x[0] < 0 and x[2] == 0)]
            skip = [r[0] > 0 and r[4] == 0 for r in recvs]
            got = iter(saved[3](mesh, axis, sends,
                                [r for r, k in zip(recvs, skip) if not k]))
            return [torch.zeros(r[1], dtype=r[2], device=r[3]) if k
                    else next(got) for r, k in zip(recvs, skip)]
        PL.stage_hop = hop
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        S.flush_deferred, A.tp_sum, M.combine_sum, PL.stage_hop = saved


def lm_run_fault(config, seed, fault):
    """:func:`lm_run` with the fault :func:`planted`."""
    with planted(fault):
        return lm_run(config, seed)


def a2a_shard(axes, x, params, cf):
    """The all-to-all MoE forward (``parallel/expert.py``) of this rank's
    rows of the global numpy tokens ``x`` (B, S, D) over the mesh of
    ``axes``, an unbiased 4-expert unit with ``params`` and no residual
    -> (its output rows, which of its tokens it kept)."""
    import torch
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz.ops.moe import MoEFFN
    m = mesh(axes)
    n, r = m.shape["expert"], m.index("expert")
    per = x.shape[0] // n
    unit = MoEFFN(experts=params["router"].shape[1],
                  hidden=params["weights"].shape[2], residual=False,
                  capacity_factor=cf)
    unit.initialize(x.shape, TorchDevice("cpu"))
    e = unit.experts // n
    for key, value in params.items():
        if key != "router":
            value = value[r * e:(r + 1) * e]
        setattr(unit, key, torch.from_numpy(value.copy()))
    unit.mesh, unit.expert_axis, unit.routing = m, "expert", "alltoall"
    y = unit(torch.from_numpy(x[r * per:(r + 1) * per].copy()))
    kept = unit.cache["dispatch"].sum(dim=(-1, -2)) > 0.5
    return y.numpy(), kept.reshape(per, x.shape[1]).numpy()


def pipeline_math(axes, params, x, target, n_micro, heads):
    """The GPipe forward and backward and the 1F1B step of the port
    (``parallel/pipeline.py``) on this rank's stage of the stacked numpy
    ``params`` and its ``data`` rows of ``x``, the error ``y − target``
    (1F1B's ``err_fn``, with the loss ½Σ(y − target)²) -> {"gpipe": (y,
    dx, stage grads), "1f1b": (y, dx, stage grads, loss)}, as numpy."""
    import torch
    from veles_torch.znicz.parallel import pipeline as PL
    m = mesh(axes)
    p, s = m.shape["pipe"], m.index("pipe")
    nd = m.shape.get("data", 1)
    d = m.index("data") if nd > 1 else 0
    per = x.shape[0] // nd
    layers = params["weights"].shape[0] // p
    mine = {k: torch.from_numpy(v[s * layers:(s + 1) * layers].copy())
            for k, v in params.items()}
    xs = torch.from_numpy(x[d * per:(d + 1) * per].copy())
    ts = torch.from_numpy(target[d * per:(d + 1) * per].copy())
    y, caches = PL.pipeline_fwd(mine, xs, m, "pipe", n_micro, heads)
    dx, grads = PL.pipeline_bwd(mine, caches, y - ts, m, "pipe", n_micro,
                                heads)

    def err_fn(y_mb, t_mb):
        return y_mb - t_mb, 0.5 * ((y_mb - t_mb) ** 2).sum()
    y2, dx2, grads2, loss = PL.pipeline_1f1b_step(
        mine, xs, ts, err_fn, m, "pipe", n_micro, heads)

    def host(g):
        return {k: v.numpy() for k, v in g.items()}
    return {"gpipe": (y.numpy(), dx.numpy(), host(grads)),
            "1f1b": (y2.numpy(), dx2.numpy(), host(grads2), float(loss))}


def dropout_mask(axes, shape, ratio, seed):
    """This rank's part of the dropout mask of a ``shape`` minibatch on the
    mesh of ``axes`` (``data`` rows, ``seq`` positions), drawn by a unit
    seeded with ``seed``."""
    import torch
    import veles_torch.prng as prng
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz.ops.dropout import DropoutForward
    m = mesh(axes)
    local = list(shape)
    if "data" in m.shape:
        local[0] //= m.shape["data"]
    if "seq" in m.shape:
        local[1] //= m.shape["seq"]
    prng.seed_all(seed)
    unit = DropoutForward(dropout_ratio=ratio, name="drop")
    unit.initialize(tuple(local), TorchDevice("cpu"))
    unit.mesh = m
    unit.batch_axes = ("data",) if "data" in m.shape else ()
    unit.seq_axis = "seq" if "seq" in m.shape else None
    return unit.draw_mask(torch.zeros(local)).numpy()


def dropout_dp(axes, seed):
    """A small MNIST MLP with a dropout unit trained 2 epochs under DP
    over ``axes`` (``axes`` empty: one process) -> (history, params)."""
    import veles_torch.prng as prng
    from veles_torch.znicz import parallel
    from veles_torch.znicz.models.mnist import MnistLoader
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
               "<-": {"learning_rate": 0.1}},
              {"type": "dropout", "->": {"dropout_ratio": 0.3}},
              {"type": "softmax", "->": {"output_sample_shape": 10},
               "<-": {"learning_rate": 0.1}}]
    prng.seed_all(seed)
    wf = StandardWorkflow(
        name="DropoutDP", layers=layers,
        loader_factory=lambda w: MnistLoader(
            w, name="loader", minibatch_size=16, n_train=64, n_valid=32),
        decision_config={"max_epochs": 2})
    wf.initialize(device="cpu")
    if axes:
        parallel.setup_data_parallel(wf, mesh(axes))
    wf.run()
    return {"history": wf.decision.history,
            "params": wf.checkpoint_state()["params"]}


def sample_dp(sample, loader, epochs, seed, axes):
    """Train the port's MNIST or CIFAR sample under DP over ``axes`` ->
    (history, params, the last train step's collectives)."""
    import importlib
    import veles_torch.prng as prng
    from veles_torch.config import root
    from veles_torch.znicz import parallel
    module = importlib.import_module("veles_torch.znicz.models." + sample)
    cfg = getattr(root, {"mnist": "mnist", "cifar10": "cifar"}[sample])
    saved = cfg.to_dict()
    try:
        cfg.loader.update(loader)
        cfg.decision.max_epochs = epochs
        prng.seed_all(seed)
        wf = module.create_workflow()
        wf.initialize(device="cpu")
        parallel.setup_data_parallel(wf, mesh(axes))
        wf.run()
        tree = wf.checkpoint_state()
        return {"history": wf.decision.history, "params": tree["params"],
                "counts": parallel.collective_counts(wf.step)}
    finally:
        cfg.update(saved)


def fail_on_rank_one(port_unused=None):
    """Rank 1 fails at once; rank 0 waits in a collective that rank 1
    never joins (the spawner must tear it down)."""
    import torch
    import torch.distributed as dist
    from veles_torch.znicz import parallel
    parallel.init_multihost(transport="gloo")
    if dist.get_rank() == 1:
        raise RuntimeError("rank one gives up")
    dist.all_reduce(torch.zeros(1))
    return "unreachable"


def som_run(axes, epochs, loader, seed):
    """The port's SOM sample trained ``epochs`` under DP over ``axes``
    (empty: one process) -> (history, final weights, time step, the last
    train step's collectives)."""
    import veles_torch.prng as prng
    from veles_torch.config import root
    from veles_torch.znicz import parallel
    from veles_torch.znicz.models import kohonen
    saved = root.kohonen.to_dict()
    try:
        root.kohonen.update({"decision": {"max_epochs": epochs},
                             "loader": dict(loader)})
        prng.seed_all(seed)
        wf = kohonen.create_workflow().initialize(device="cpu")
        if axes:
            parallel.setup_data_parallel(wf, mesh(axes))
        wf.run()
        return {"history": wf.decision.history,
                "weights": wf.forwards[0].weights.numpy(),
                "time_step": float(wf.trainer.time_step),
                "counts": parallel.collective_counts(wf.step)}
    finally:
        root.kohonen.update(saved)


def rbm_run(axes, epochs, loader, seed):
    """The port's MnistRBM sample trained ``epochs`` under DP over
    ``axes`` (empty: one process) -> (history, params, every uniform
    array this rank's binarization drew, the first train step's samples,
    the last train step's collectives)."""
    import veles_torch.prng as prng
    from veles_torch.config import root
    from veles_torch.znicz import parallel
    from veles_torch.znicz.models import mnist_rbm
    saved = root.mnist_rbm.to_dict()
    try:
        root.mnist_rbm.update({"decision": {"max_epochs": epochs},
                               "loader": dict(loader)})
        prng.seed_all(seed)
        wf = mnist_rbm.create_workflow().initialize(device="cpu")
        if axes:
            parallel.setup_data_parallel(wf, mesh(axes))
        drawn, first = [], []
        unit = wf.binarize
        plain = unit.uniforms

        def recording(p):
            u = plain(p)
            drawn.append(u.numpy().copy())
            if not first and wf.step.in_train:
                first.append(unit.sample(p, u).numpy())
            return u
        unit.uniforms = recording
        wf.run()
        return {"history": wf.decision.history,
                "params": wf.checkpoint_state()["params"],
                "uniforms": drawn, "first_samples": first[0],
                "counts": parallel.collective_counts(wf.step)}
    finally:
        root.mnist_rbm.update(saved)


def rbm_steps(axes, params, batches, uniforms, valids, n_hidden, lr):
    """CD-1 steps of the port's RBM units under DP over ``axes`` with the
    minibatch's uniforms injected: this rank takes its rows of each
    (mb, visible) batch and of its (mb, hidden) uniforms -> (each step's
    metrics row of this rank, the final params)."""
    import numpy
    import torch
    from veles_torch.backends import TorchDevice
    from veles_torch.znicz import parallel
    from veles_torch.znicz.ops.all2all import All2AllSigmoid
    from veles_torch.znicz.ops.rbm import (
        BatchWeights, Binarization, EvaluatorRBM, GradientRBM,
        TiedAll2AllSigmoid)
    m = mesh(axes)
    n = m.axis_size("data")
    r = m.index("data")
    mb, visible = batches[0].shape
    per = -(-mb // n)
    dev = TorchDevice("cpu")
    h_pos = All2AllSigmoid(name="h_pos", output_sample_shape=n_hidden)
    h_pos.initialize((per, visible), dev)
    h_pos.weights = torch.as_tensor(params["w"])
    h_pos.bias = torch.as_tensor(params["hb"])
    binarize = Binarization(name="binarize")
    binarize.initialize((per, n_hidden), dev)
    v_neg = TiedAll2AllSigmoid(name="v_neg", weights_source=h_pos,
                               transposed=True, output_sample_shape=visible)
    v_neg.initialize((per, n_hidden), dev)
    v_neg.bias = torch.as_tensor(params["vb"])
    h_neg = TiedAll2AllSigmoid(name="h_neg", weights_source=h_pos,
                               bias_source=h_pos, output_sample_shape=n_hidden)
    h_neg.initialize((per, visible), dev)
    stats = [BatchWeights(name="pos"), BatchWeights(name="neg")]
    for unit in stats + [binarize]:
        unit.mesh, unit.batch_axes = m, ("data",)
    grad = GradientRBM(learning_rate=lr)
    grad.hidden_layer, grad.visible_layer = h_pos, v_neg
    rows = []
    for batch, u, valid in zip(batches, uniforms, valids):
        full = numpy.zeros((per * n, visible), numpy.float32)
        full[:mb] = batch
        whole_u = numpy.zeros((per * n, n_hidden))
        whole_u[:mb] = u
        binarize.uniforms = lambda p, whole_u=whole_u: torch.as_tensor(
            whole_u[r * per:(r + 1) * per])
        v = torch.as_tensor(full[r * per:(r + 1) * per])
        mine = int(min(max(valid - r * per, 0), per))
        count = (torch.tensor(mine), torch.tensor(int(valid)))
        h = h_pos(v)
        vn = v_neg(binarize(h))
        hn = h_neg(vn)
        rows.append(EvaluatorRBM().run(v, vn, count).numpy())
        grad.run(stats[0](v, h, count), stats[1](vn, hn, count))
    return {"rows": rows, "w": h_pos.weights.numpy(),
            "hb": h_pos.bias.numpy(), "vb": v_neg.bias.numpy()}


def stream_dp(axes, minibatch, seed):
    """A small MNIST MLP over ``ArrayStreamLoader`` (the stream path)
    trained 2 epochs under DP over ``axes`` (empty: one process) ->
    (history, params, the stream path's windows)."""
    import numpy
    import veles_torch.prng as prng
    from veles_torch.loader.stream import ArrayStreamLoader
    from veles_torch.znicz import parallel
    from veles_torch.znicz.standard_workflow import StandardWorkflow
    gen = numpy.random.Generator(numpy.random.PCG64(seed))
    data = gen.normal(0, 1, (150, 28, 28)).astype(numpy.float32)
    labels = gen.integers(0, 10, 150).astype(numpy.int32)
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 24},
               "<-": {"learning_rate": 0.05}},
              {"type": "softmax", "->": {"output_sample_shape": 10},
               "<-": {"learning_rate": 0.05}}]
    prng.seed_all(seed)
    wf = StandardWorkflow(
        name="StreamDP", layers=layers,
        loader_factory=lambda w: ArrayStreamLoader(
            w, name="loader", minibatch_size=minibatch, data=data,
            labels=labels, class_lengths=[0, 41, 109]),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    wf.initialize(device="cpu")
    if axes:
        parallel.setup_data_parallel(wf, mesh(axes))
    assert wf.loader.supports_streaming
    wf.run()
    return {"history": wf.decision.history,
            "params": wf.checkpoint_state()["params"],
            "windows": wf.step.last_window_minibatches}


def slave_dp(axes, address, max_epochs):
    """The MNIST chain of tests/torch_cluster.py as ONE slave of the
    mesh's ranks (unshuffled) under the master at ``address``, through the
    launcher's slave path: rank 0 holds the wire and relays each job,
    every rank runs it on its share -> the jobs this rank ran (rank 0:
    the client's count)."""
    from tests.torch_cluster import port_wf
    from veles_torch.launcher import Launcher
    from veles_torch.znicz import parallel
    wf = port_wf("DPSlave", role="slave", shuffle=False,
                 max_epochs=max_epochs)
    parallel.setup_data_parallel(wf, mesh(axes))
    launcher = Launcher(device="cpu", master_address=address)
    launcher.workflow = wf
    launcher._run_slave()
    client = launcher.slave_client
    return None if client is None else client.jobs_done
