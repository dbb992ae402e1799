"""Entry point of the port's multi-rank dry run.

Counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``:
:func:`dryrun_multichip` spawns ``n`` ranks (``parallel.spawn``), each
builds the tiny MNIST and the tiny LM from the same seed and runs ONE
full train step (forward, evaluator, reversed GD chain, the gradient
all-reduce and the updates) under each mode, and asserts the collectives
that step issued, as the reference asserts its HLO opcodes:

* MNIST under DP over every rank: ``all-reduce``;
* the LM under DP × TP (``model`` the largest of 1, 2, 4 dividing n):
  ``all-reduce``;
* the LM under the ring (``seq`` = gcd(n, 16), data over the rest), with
  the dense inner block and with the scan (``attn_impl="scan"``):
  ``collective-permute``;
* the MoE LM under data × expert (``expert`` as ``model`` above, one
  expert a rank), gather routing: ``all-gather`` and ``all-reduce``; the
  all-to-all routing: ``all-to-all`` and ``all-reduce``, no
  ``all-gather``;
* the stacked LM under data × pipe (one block a stage, 4 microbatches),
  GPipe and 1F1B: ``collective-permute`` and ``all-reduce``;
* the LM under data × model 2 × seq 2 when ``n % 8 == 0``: both.

Every leg of the reference runs. The ranks run on
the card unless the caller asks for the host: there ``transport`` is
``"nccl"`` (the default, one card per rank, refused when there are fewer
cards than ranks) or ``"gloo-host"`` (ranks sharing one card, the
collectives copied through the host); ``device="cpu"`` runs the legs on
gloo ranks of the host.

    python -c "from veles_torch.graft_entry import dryrun_multichip; \\
print(dryrun_multichip(4))"                  # 4 cards, NCCL
    python -c "from veles_torch.graft_entry import dryrun_multichip; \\
print(dryrun_multichip(4, device='cpu'))"    # 4 gloo ranks of the host
"""

import math

def _one_train_step(wf):
    """One train step of the workflow's first train minibatch, as its
    rank serves it; -> the step's collective counts."""
    from veles_torch.loader.base import CLASS_TRAIN
    from veles_torch.znicz import parallel
    step = wf.step
    dev = wf.device.device
    plan = step.shard_plan(wf.loader.epoch_plan())
    cls, idx, mine, _, valids, _ = next(p for p in plan
                                        if p[0] == CLASS_TRAIN)
    import torch
    full = wf.loader.device_full_arrays(dev)
    data, target = step.gather(
        full, torch.as_tensor(idx[0], dtype=torch.int64).to(dev), True)
    valid = torch.as_tensor([int(mine[0]), int(valids[0])]).to(dev)
    step.train_minibatch(data, target, (valid[0], valid[1]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return parallel.collective_counts(step)


def _tiny_mnist(device, n):
    import veles_torch.prng as prng
    from veles_torch.config import root
    from veles_torch.znicz import parallel
    from veles_torch.znicz.models import mnist
    prng.seed_all(1)
    root.mnist.loader.update({"minibatch_size": 16, "n_train": 64,
                              "n_valid": 32})
    root.mnist.decision.max_epochs = 1
    wf = mnist.create_workflow(name="DryrunMultichip")
    wf.initialize(device=device)
    parallel.setup_data_parallel(wf, parallel.make_mesh({"data": n}))
    return wf


def _tiny_lm(device, name, spec, model_extra=None):
    import veles_torch.prng as prng
    from veles_torch.config import root
    from veles_torch.znicz.models import transformer_lm
    prng.seed_all(2)
    root.lm.loader.update({"minibatch_size": 16, "n_train": 32,
                           "n_valid": 16, "seq_len": 16})
    root.lm.model.update({"dim": 16, "heads": 4, "layers": 1,
                          "ffn_hidden": 32, "moe_experts": 0,
                          "stacked": False, "attn_impl": None,
                          "attn_block": None})
    root.lm.model.update(model_extra or {})
    root.lm.decision.max_epochs = 1
    root.lm.parallel.update({"seq": 1, "model": 1, "data": 1,
                             "expert": 1, "pipe": 1, "microbatches": 4,
                             "ep_routing": "gather", "schedule": "gpipe"})
    root.lm.parallel.update(spec)
    wf = transformer_lm.create_workflow(name=name)
    wf.initialize(device=device)
    return wf


def legs(n):
    """[(name, workflow kind, parallel spec, model extras, expected
    collectives)] of the dry run on ``n`` ranks."""
    tp = max(d for d in (1, 2, 4) if n % d == 0)
    seq = math.gcd(n, 16)
    out = [("DryrunDP", "mnist", {"data": n}, None, ("all-reduce",)),
           ("DryrunTP", "lm", {"data": n // tp, "model": tp}, None,
            ("all-reduce",))]
    if seq > 1:
        ring = {"data": n // seq, "seq": seq}
        out += [("DryrunRing", "lm", ring, None, ("collective-permute",)),
                ("DryrunRingFlash", "lm", ring, {"attn_impl": "scan"},
                 ("collective-permute",))]
    if tp > 1:
        ep = {"data": n // tp, "expert": tp}
        pp = {"data": n // tp, "pipe": tp, "microbatches": 4}
        out += [("DryrunEPGather", "lm", ep, {"moe_experts": tp},
                 ("all-gather", "all-reduce")),
                ("DryrunEPAllToAll", "lm", dict(ep, ep_routing="alltoall"),
                 {"moe_experts": tp}, ("all-to-all", "all-reduce")),
                ("DryrunPP", "lm", pp, {"layers": tp, "stacked": True},
                 ("collective-permute", "all-reduce")),
                ("DryrunPP1F1B", "lm", dict(pp, schedule="1f1b"),
                 {"layers": tp, "stacked": True},
                 ("collective-permute", "all-reduce"))]
    if n % 8 == 0:
        out.append(("DryrunCombo", "lm",
                    {"data": n // 4, "model": 2, "seq": 2}, None,
                    ("all-reduce", "collective-permute")))
    return out


def _dryrun_rank(n, device, transport):
    import torch
    from veles_torch.config import root
    from veles_torch.znicz import parallel
    torch.set_num_threads(1)
    parallel.init_multihost(transport=transport)
    if transport == "nccl":
        import os
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        device = "cuda:%d" % local
    saved = {k: getattr(root, k).to_dict() for k in ("mnist", "lm")}
    report = {}
    try:
        for name, kind, spec, extra, expect in legs(n):
            wf = _tiny_mnist(device, n) if kind == "mnist" \
                else _tiny_lm(device, name, spec, extra)
            _one_train_step(wf)
            counts = parallel.assert_collectives(wf.step, expect)
            if name == "DryrunEPAllToAll" and counts.get("all-gather"):
                raise AssertionError(
                    "%s gathered tokens (%s): the exchange must move each "
                    "token once" % (name, counts))
            report[name] = {"mesh": dict(wf.mesh.shape),
                            "collectives": counts}
    finally:
        for k, tree in saved.items():
            getattr(root, k).update(tree)
        torch.distributed.destroy_process_group()
    return report


def dryrun_multichip(n_devices, device="cuda", transport=None,
                     timeout_s=600.0):
    """One full train step under every mode on ``n_devices`` ranks (module
    docstring); -> {"legs": rank 0's {leg: mesh, collectives},
    "transport"}. Raises when a rank fails or a leg lacks a
    collective it must issue."""
    from veles_torch.znicz import parallel
    n = int(n_devices)
    transport = parallel.declared_transport(device, transport, n)
    reports = parallel.spawn(_dryrun_rank, n, args=(n, device, transport),
                             timeout_s=timeout_s)
    return {"legs": reports[0], "transport": transport}
