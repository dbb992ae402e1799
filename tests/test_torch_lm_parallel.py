"""The port's LM sharded from ``root.lm.parallel`` alone (veles_torch/znicz/
models/transformer_lm.py, ``TransformerLMWorkflow._setup_parallel``)
against the JAX package's same config on its 8-device virtual CPU mesh,
after tests/test_lm_parallel.py: ring attention (``seq`` 2 and 4),
Megatron TP (``model`` 2 and 4), ``data`` 2 × ``model`` 2, ``seq`` 2 ×
``data`` 2 and ``seq`` 2 × ``model`` 2 (TP of the FFN alone: the ring
owns the attention), each within 1e-5 of the reference after one epoch
(validation history and every parameter and momentum); DP and TP
checkpoints that hold the full tensors, restore into the reference and
onto one device, and re-shard onto the mesh; the collectives of each
mode; a TP run's inference archive with the full tensors; the axes of
ROADMAP Queue 1 item 10c refused. The ranks are two
groups of gloo processes (2 and 4) spawned once for the module
(tests/torch_parallel_workers.py); the CLI line of each mode is in
tests/test_torch_launcher.py."""

import os

import numpy
import pytest

import veles.prng as jprng
from veles.config import root as jroot
from veles.snapshotter import load_snapshot as jload_snapshot
from veles.znicz_tpu.models import transformer_lm as jlm
import veles_torch.prng as tprng
from veles_torch.config import root as troot
from veles_torch.snapshotter import load_snapshot
from veles_torch.znicz.models import transformer_lm as tlm
from tests.torch_parallel_workers import RankGroup

LOADER = {"minibatch_size": 16, "n_train": 128, "n_valid": 32,
          "seq_len": 16, "vocab": 8, "max_period": 4}
MODEL = {"dim": 32, "heads": 4, "layers": 1, "ffn_hidden": 64,
         "attn_block": None, "attn_impl": None, "moe_experts": 0,
         "stacked": False}
SEED = 777
#: one epoch (8 train steps) under each mode against the reference's
#: same mode: parameters, momentum and validation losses (observed
#: ≤ 2.2e-7)
ATOL = 1e-5
NO_AXES = {"seq": 1, "model": 1, "data": 1, "expert": 1, "pipe": 1}


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


def config(parallel, epochs=1):
    return {"loader": LOADER, "model": MODEL,
            "decision": {"max_epochs": epochs},
            "parallel": dict(NO_AXES, **parallel)}


def run_reference(parallel, epochs=1):
    saved = jroot.lm.to_dict()
    try:
        for section, values in config(parallel, epochs).items():
            getattr(jroot.lm, section).update(values)
        jprng.seed_all(SEED)
        wf = jlm.create_workflow(name="TorchLMParallel")
        wf.initialize(device="cpu")
        wf.run()
        wf.xla_step.sync_host()
        return wf
    finally:
        jroot.lm.update(saved)


def reference_tree(wf):
    return {u.name: {**u.export_params(), **u.export_state()}
            for u in wf.forwards + wf.gds}


def assert_close_to(wf, port):
    want = reference_tree(wf)
    got = {**port["params"], **port["state"]}
    worst = 0.0
    for unit, sub in want.items():
        for key, value in sub.items():
            err = numpy.abs(numpy.asarray(got[unit][key], numpy.float64)
                            - numpy.asarray(value, numpy.float64)).max()
            assert err <= ATOL, (unit, key, err)
            worst = max(worst, err)
    hist_w = [h["validation"]["metric"] for h in wf.decision.history]
    hist_g = [h["validation"]["metric"] for h in port["history"]]
    assert numpy.allclose(hist_g, hist_w, rtol=0, atol=ATOL), \
        (hist_g, hist_w)
    return worst


#: (root.lm.parallel, the collectives a train step must issue)
MODES = [
    ({"seq": 2}, ("collective-permute", "all-reduce")),
    ({"seq": 4}, ("collective-permute", "all-reduce")),
    ({"model": 2}, ("all-reduce",)),
    ({"model": 4}, ("all-reduce",)),
    ({"data": 2, "model": 2}, ("all-reduce",)),
    ({"seq": 2, "data": 2}, ("collective-permute", "all-reduce")),
    ({"seq": 2, "model": 2}, ("collective-permute", "all-reduce")),
]


@pytest.mark.parametrize("parallel,collectives", MODES,
                         ids=[str(m) for m, _ in MODES])
def test_lm_from_config_matches_reference(groups, parallel, collectives):
    """Every rank ends the epoch with the same gathered state, and it and
    the validation history are the reference's within 1e-5. Per train
    step (1 layer): TP all-reduces the attention's and the FFN's partial
    sums forward and their input gradients backward (4), the FFN's alone
    (2) where the ring owns the attention (seq × model); the ring hops
    (k, v) n−1 times forward and (k, v, dk, dv) n−1 times + (dk, dv)
    once backward; data and seq add the one gradient bucket."""
    n = int(numpy.prod(list(parallel.values())))
    res = groups(n).run("lm_run", config(parallel), SEED)
    for r in res[1:]:
        assert r["history"] == res[0]["history"]
    assert res[0]["mesh"] == parallel
    assert_close_to(run_reference(parallel), res[0])
    counts = res[0]["counts"]
    assert all(counts.get(op) for op in collectives), counts
    seq, model = parallel.get("seq", 1), parallel.get("model", 1)
    want = {}
    if seq > 1:
        want["collective-permute"] = 2 * (seq - 1) + 4 * (seq - 1) + 2
    tp_units = 1 + (seq == 1)       # the FFN, and the attention unless
    reduces = (2 * tp_units if model > 1 else 0) + (  # the ring owns it
        1 if seq * parallel.get("data", 1) > 1 else 0)
    want["all-reduce"] = reduces
    # the last step of the epoch is the 8th: layer stats were not due
    assert counts == want, (counts, want)


def test_dp_and_tp_checkpoints_hold_full_tensors(groups, tmp_path):
    """After tests/test_lm_parallel.py's snapshot cases: a data=2 and a
    model=2 run each write (rank 0 only) the checkpoint of the epoch's
    validation, taken before the first train step, with the FULL
    parameters and solver state: bit for bit the one-device initial state
    of the seed. The reference restores it bit for bit; the port resumes
    it onto one device and onto the mesh (re-sharded under TP), and both
    end the epoch within 1e-5 of the uninterrupted mesh run."""
    saved = troot.lm.to_dict()
    try:
        for section, values in config({}).items():
            getattr(troot.lm, section).update(values)
        tprng.seed_all(SEED)
        fresh = tlm.create_workflow(name="TorchLMParallel")
        fresh.initialize(device="cpu")
        initial = fresh.checkpoint_state()
    finally:
        troot.lm.update(saved)
    for parallel in ({"data": 2}, {"model": 2}):
        snaps = str(tmp_path / "_".join(parallel))
        res = groups(2).run("lm_run", config(parallel), SEED, snaps)
        path = res[0]["destination"]
        assert path and os.path.exists(path), res[0]["destination"]
        assert res[1]["destination"] is None     # rank 1 writes nothing
        assert len(os.listdir(snaps)) == 1
        state = load_snapshot(path)
        for section in ("params", "state"):
            for unit, sub in initial[section].items():
                for key, value in sub.items():
                    assert numpy.array_equal(state[section][unit][key],
                                             value), (parallel, unit, key)
        # into the reference, one device
        saved = jroot.lm.to_dict()
        try:
            for section, values in config({}).items():
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
                assert numpy.array_equal(
                    numpy.asarray(value), state["params"][f.name][key])
        # resumed onto one device of the port
        saved = troot.lm.to_dict()
        try:
            for section, values in config({}).items():
                getattr(troot.lm, section).update(values)
            tprng.seed_all(SEED)
            one = tlm.create_workflow(name="TorchLMParallel")
            one.initialize(device="cpu")
            one.restore_state(state)
            one.run()
            single = one.checkpoint_state()
        finally:
            troot.lm.update(saved)
        # resumed onto the mesh of the run
        again = groups(2).run("lm_run", config(parallel), SEED, None,
                              path)[0]
        for got in (single, again):
            for unit, sub in res[0]["params"].items():
                for key, value in sub.items():
                    err = numpy.abs(got["params"][unit][key] - value).max()
                    assert err <= ATOL, (parallel, unit, key, err)


def test_tp_inference_archive_holds_full_tensors(groups, tmp_path):
    """A model=2 run's inference archive, written by rank 0 alone from
    the shards gathered over the model axis: the one-device archive's
    contents.json of the same config (every head and FFN unit) and, file
    for file, the run's gathered parameters bit for bit."""
    import json
    got_dir = str(tmp_path / "tp")
    res = groups(2).run("lm_run", config({"model": 2}), SEED, None, None,
                        got_dir)
    assert res[0]["archive"] == os.path.join(got_dir, "contents.json")
    assert res[1]["archive"] is None
    saved = troot.lm.to_dict()
    try:
        for section, values in config({}).items():
            getattr(troot.lm, section).update(values)
        tprng.seed_all(SEED)
        one = tlm.create_workflow(name="TorchLMParallel")
        one.initialize(device="cpu")
        want = one.export_inference(str(tmp_path / "one"))
    finally:
        troot.lm.update(saved)
    with open(res[0]["archive"]) as f:
        doc = json.load(f)
    with open(want) as f:
        assert doc == json.load(f)
    compared = 0
    for unit in doc["units"]:
        for key, value in res[0]["params"].get(unit["name"], {}).items():
            arr = numpy.load(os.path.join(got_dir, unit[key]))
            assert numpy.array_equal(arr, value), (unit["name"], key)
            compared += 1
    assert compared == sum(len(v) for v in res[0]["params"].values())


@pytest.mark.parametrize("fault,parallel", [("grad", {"data": 2}),
                                            ("tp", {"model": 2})], ids=str)
def test_movement_bar_sees_a_skipped_all_reduce(groups, fault, parallel):
    """``chip_smoke.py`` holds the card's parallel 110M runs against one
    process by each tensor's movement, max|Δ_par − Δ_1| / max|Δ_1| over
    the worst tensor (Δ: the weights less the seed's), within
    ``PARALLEL_BF16_RTOL`` under the bf16 policy. A planted skipped
    all-reduce (the gradient bucket under DP; TP's partial sums and input
    gradients) must read well above that bar, the sound run far below
    it."""
    import chip_smoke
    saved = troot.lm.to_dict()
    try:
        for section, values in config({}).items():
            getattr(troot.lm, section).update(values)
        tprng.seed_all(SEED)
        one = tlm.create_workflow(name="TorchLMParallel")
        one.initialize(device="cpu")
        start = one.checkpoint_state()["params"]
        one.run()
        want = one.checkpoint_state()["params"]
    finally:
        troot.lm.update(saved)

    def worst(got):
        out = 0.0
        for unit, sub in want.items():
            for key, value in sub.items():
                moved = numpy.abs(value - start[unit][key]).max()
                out = max(out, numpy.abs(got[unit][key] - value).max()
                          / max(moved, 1e-30))
        return out
    sound = worst(groups(2).run("lm_run", config(parallel), SEED)[0]
                  ["params"])
    broken = worst(groups(2).run("lm_run_fault", config(parallel), SEED,
                                 fault)[0]["params"])
    bar = chip_smoke.PARALLEL_BF16_RTOL
    assert sound < 1e-3 * bar, (sound, broken)
    assert broken > 2 * bar, (sound, broken)


@pytest.mark.parametrize("parallel,model", [
    ({"expert": 2}, {}), ({"pipe": 2}, {"stacked": True}),
    ({"data": 2}, {"moe_experts": 4}), ({"seq": 2}, {"moe_experts": 4}),
    ({"model": 2}, {"moe_experts": 4})], ids=str)
def test_item_10c_refused(parallel, model):
    """Expert and pipeline parallelism, and an MoE under any axis, raise
    naming ROADMAP Queue 1 item 10c before any rank is spawned."""
    saved = troot.lm.to_dict()
    try:
        troot.lm.parallel.update(dict(NO_AXES, **parallel))
        troot.lm.model.update(dict(MODEL, **model))
        with pytest.raises(NotImplementedError, match=r"item 10c\)"):
            tlm.parallel_ranks()
        with pytest.raises(NotImplementedError, match=r"item 10c\)"):
            tlm.create_workflow()
    finally:
        troot.lm.update(saved)
