"""Rank processes of the port's parallel tests: a group of gloo ranks on
``tcp://localhost`` (the port's counterpart of the reference's 8-device
virtual CPU mesh), spawned once per test module and fed tasks by name.

A spawned rank imports this light module, never a test module (which
imports the JAX package). Each rank runs one torch thread; every wait is
bounded.
"""

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
    saved = root.lm.to_dict()
    try:
        for section, values in config.items():
            getattr(root.lm, section).update(values)
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
                "mesh": None if wf.mesh is None else dict(wf.mesh.shape),
                "coords": None if wf.mesh is None else wf.mesh.coords,
                "destination": wf.snapshotter.destination
                if wf.snapshotter is not None else None}
    finally:
        root.lm.update(saved)


def lm_run_fault(config, seed, fault):
    """:func:`lm_run` with a planted fault, undone after: ``"grad"`` skips
    the gradient bucket's all-reduce, ``"tp"`` the all-reduces of TP's
    partial sums and input gradients."""
    from veles_torch.znicz import step as S
    from veles_torch.znicz.ops import attention as A
    saved = S.flush_deferred, A.tp_sum
    if fault == "grad":
        S.flush_deferred = lambda entries, reduce: saved[0](
            entries, lambda flat: flat)
    elif fault == "tp":
        A.tp_sum = lambda unit, t: t
    else:
        raise ValueError(fault)
    try:
        return lm_run(config, seed)
    finally:
        S.flush_deferred, A.tp_sum = saved


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
