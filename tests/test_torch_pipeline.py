"""The port's pipeline parallelism (veles_torch/znicz/parallel/pipeline.py,
veles_torch/znicz/ops/transformer_stack.py, set up from ``root.lm.parallel``
alone) against the JAX package's on its 8-device virtual CPU mesh, after
tests/test_pipeline.py: GPipe's forward and backward and the 1F1B step
on ``pipe`` 2 and 4 and ``pipe`` 2 × ``data`` 2, microbatches 2 and 4,
against the reference's ``stack_fwd`` + ``stack_bwd``; the stacked LM
under GPipe and 1F1B within 1e-5 of the reference's same mode after one
epoch (every parameter, its solver state, the validation history), 1F1B
leaf for leaf against GPipe, and one chunk forward per microbatch per
stage in a folded 1F1B train step; ``build_1f1b_schedule`` equal to the
reference's arrays for P ≤ 4, M ≤ 8, with its stash bound; a PP
checkpoint with the full tensors that restores into the reference and
onto one device; a skipped backward hop read above ``chip_smoke.py``'s
movement bar. The ranks are gloo processes (groups of 2 and 4) spawned
once for the module (tests/torch_parallel_workers.py)."""

import os

import jax
import numpy
import pytest

import veles.prng as jprng
from veles.config import root as jroot
from veles.snapshotter import load_snapshot as jload_snapshot
from veles.znicz_tpu.models import transformer_lm as jlm
from veles.znicz_tpu.parallel import pipeline as JPL
from veles_torch.snapshotter import load_snapshot
from veles_torch.znicz.parallel import pipeline as TPL
from tests.torch_parallel_workers import RankGroup

LOADER = {"minibatch_size": 16, "n_train": 128, "n_valid": 32,
          "seq_len": 16, "vocab": 8, "max_period": 4}
MODEL = {"dim": 32, "heads": 2, "layers": 4, "ffn_hidden": 64,
         "attn_block": None, "attn_impl": None, "moe_experts": 0,
         "stacked": True}
SEED = 606
#: one epoch (8 train steps) against the reference's same mode
#: (observed ≤ 2.4e-7)
ATOL = 1e-5
#: the schedules' outputs and gradients against the reference's
#: single-program stack (observed ≤ 2e-6)
MATH_ATOL = 2e-5
NO_AXES = {"seq": 1, "model": 1, "data": 1, "expert": 1, "pipe": 1,
           "microbatches": 4, "schedule": "gpipe"}


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


def run_reference(parallel):
    saved = jroot.lm.to_dict()
    try:
        for section, values in config(parallel).items():
            getattr(jroot.lm, section).update(values)
        jprng.seed_all(SEED)
        wf = jlm.create_workflow(name="TorchLMParallel")
        wf.initialize(device="cpu")
        wf.run()
        wf.xla_step.sync_host()
        return wf
    finally:
        jroot.lm.update(saved)


def assert_trees(want, got, atol):
    for unit, sub in want.items():
        for key, value in sub.items():
            err = numpy.abs(numpy.asarray(got[unit][key], numpy.float64)
                            - numpy.asarray(value, numpy.float64)).max()
            assert err <= atol, (unit, key, err)


def assert_close_to(wf, port):
    assert_trees({u.name: {**u.export_params(), **u.export_state()}
                  for u in wf.forwards + wf.gds},
                 {**port["params"], **port["state"]}, ATOL)
    hist_w = [h["validation"]["metric"] for h in wf.decision.history]
    hist_g = [h["validation"]["metric"] for h in port["history"]]
    assert numpy.allclose(hist_g, hist_w, rtol=0, atol=ATOL), \
        (hist_g, hist_w)


def _stack_inputs(seed=77, L=4, B=8, S=6, D=8, H=16):
    gen = numpy.random.default_rng(seed)
    shapes = {"weights": (L, D, 3 * D), "bias": (L, 3 * D),
              "weights_out": (L, D, D), "bias_out": (L, D),
              "ln1_g": (L, D), "ln1_b": (L, D),
              "ffn_w1": (L, D, H), "ffn_b1": (L, H),
              "ffn_w2": (L, H, D), "ffn_b2": (L, D),
              "ln2_g": (L, D), "ln2_b": (L, D)}
    params = {}
    for k, shp in shapes.items():
        if k.endswith("_g"):
            params[k] = numpy.ones(shp, numpy.float32)
        elif "bias" in k or k.endswith("_b"):
            params[k] = gen.normal(0, 0.1, shp).astype(numpy.float32)
        else:
            params[k] = gen.normal(0, 0.3, shp).astype(numpy.float32)
    x = gen.normal(0, 1.0, (B, S, D)).astype(numpy.float32)
    t = gen.normal(0, 1.0, (B, S, D)).astype(numpy.float32)
    return params, x, t


@pytest.mark.parametrize("pipe,data,micro", [(2, 1, 2), (2, 1, 4),
                                              (4, 1, 4), (2, 2, 2)],
                         ids=["pp2m2", "pp2m4", "pp4m4", "dp2xpp2m2"])
def test_schedules_match_reference_stack(groups, pipe, data, micro):
    """GPipe (``pipeline_fwd`` + ``pipeline_bwd``) and the 1F1B step, on
    each rank's stage and data rows, put together over the ranks (the
    stage gradients summed over ``data``): the reference's ``stack_fwd``
    and ``stack_bwd`` of the whole stack and minibatch, the error y −
    target, within 2e-5; the 1F1B loss is ½Σ(y − target)²."""
    heads = 2
    params, x, t = _stack_inputs()
    y_ref, caches = jax.jit(lambda p, xx: JPL.stack_fwd(
        p, xx, heads, True, 1e-5))(params, x)
    dx_ref, g_ref = jax.jit(lambda p, c, e: JPL.stack_bwd(
        p, c, e, heads, 1e-5))(params, caches, y_ref - t)
    y_ref, dx_ref = numpy.asarray(y_ref), numpy.asarray(dx_ref)
    axes = (("data", data), ("pipe", pipe)) if data > 1 \
        else (("pipe", pipe),)
    res = groups(pipe * data).run("pipeline_math", axes, params, x, t,
                                  micro, heads)
    per = x.shape[0] // data
    for kind in ("gpipe", "1f1b"):
        for rank, out in enumerate(res):
            d, s = divmod(rank, pipe)
            rows = slice(d * per, (d + 1) * per)
            assert numpy.abs(out[kind][0] - y_ref[rows]).max() <= MATH_ATOL
            assert numpy.abs(out[kind][1] - dx_ref[rows]).max() \
                <= MATH_ATOL
        layers = params["weights"].shape[0] // pipe
        for key, want in g_ref.items():
            got = numpy.concatenate([
                sum(res[d * pipe + s][kind][2][key] for d in range(data))
                for s in range(pipe)])
            assert got.shape[0] == layers * pipe
            assert numpy.abs(got - numpy.asarray(want)).max() <= MATH_ATOL, \
                (kind, key)
    loss = 0.5 * float(((y_ref - t) ** 2).sum())
    got = sum(res[d * pipe]["1f1b"][3] for d in range(data))
    assert abs(got - loss) <= 1e-4 * loss


#: root.lm.parallel of the workflow cases
MODES = [{"pipe": 2}, {"pipe": 2, "schedule": "1f1b"},
         {"pipe": 4, "schedule": "1f1b"},
         {"pipe": 2, "data": 2}, {"pipe": 2, "data": 2, "schedule": "1f1b"}]


@pytest.mark.parametrize("parallel", MODES, ids=str)
def test_pp_lm_matches_reference(groups, parallel):
    """Every rank ends the epoch with the same gathered state, within 1e-5
    of the reference's same mode. A train step hops each microbatch's
    activations once forward and its error once backward per stage
    boundary (rank 0, stage 0: M sends), psums y and dx over ``pipe`` (2
    all-reduces) and sums the gradients over ``data`` (1); a folded 1F1B
    step forwards each microbatch once per stage."""
    n = parallel["pipe"] * parallel.get("data", 1)
    res = groups(n).run("lm_run", config(parallel), SEED)
    for r in res[1:]:
        assert r["history"] == res[0]["history"]
    assert_close_to(run_reference(parallel), res[0])
    micro = NO_AXES["microbatches"]
    want = {"collective-permute": micro,
            "all-reduce": 2 + (parallel.get("data", 1) > 1)}
    assert res[0]["counts"] == want, res[0]["counts"]
    train, evals = res[0]["steps"]
    for r in res:
        assert r["chunks"] == {"forward": micro * (train + evals),
                               "backward": micro * train}, r["chunks"]


def test_1f1b_equals_gpipe_leaf_for_leaf(groups):
    """The same stacked LM under ``pipe`` 2, 1F1B and GPipe: every
    parameter and solver leaf within 1e-6 after one epoch (the same
    microbatch math in another order; the folded loss tail multiplies by
    the minibatch's 1/(valid·S) where the evaluator divides)."""
    gpipe = groups(2).run("lm_run", config({"pipe": 2}), SEED)[0]
    ofob = groups(2).run("lm_run", config({"pipe": 2,
                                           "schedule": "1f1b"}), SEED)[0]
    assert_trees(gpipe["params"], ofob["params"], 1e-6)
    assert_trees(gpipe["state"], ofob["state"], 1e-6)


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("micro", [1, 2, 3, 4, 5, 6, 7, 8])
def test_1f1b_schedule_equals_reference(stages, micro):
    """``build_1f1b_schedule`` is the reference's, array for array, and
    stage s never holds more than min(M, P − s) microbatches' caches."""
    got = TPL.build_1f1b_schedule(stages, micro)
    want = JPL.build_1f1b_schedule(stages, micro)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and numpy.array_equal(g, w)
    actions, fidx, bidx = got
    for s in range(stages):
        live, peak = 0, 0
        for t in range(len(actions)):
            live += {1: 1, 2: -1}.get(int(actions[t, s]), 0)
            peak = max(peak, live)
        assert peak <= min(micro, stages - s), (s, peak)


def test_pp_checkpoint_restores_single_device(groups, tmp_path):
    """After tests/test_pipeline.py's snapshot case: a ``pipe`` 2 1F1B run
    writes (rank 0 only) checkpoints with the FULL stacked tensors and
    solver state, and an inference archive with the full tensors; the
    reference restores the checkpoint bit for bit onto
    one device; the port resumes it onto one device and back onto the
    pipe, both ending the epoch within 1e-5 of the pipelined run."""
    import json
    parallel = {"pipe": 2, "schedule": "1f1b"}
    snaps, archive = str(tmp_path / "pp"), str(tmp_path / "archive")
    res = groups(2).run("lm_run", config(parallel), SEED, snaps, None,
                        archive)
    path = res[0]["destination"]
    assert path and os.path.exists(path) and res[1]["destination"] is None
    state = load_snapshot(path)
    stack = next(n for n, sub in state["params"].items() if "ln1_g" in sub)
    assert state["params"][stack]["weights"].shape == (4, 32, 96)
    with open(res[0]["archive"]) as f:
        unit = next(u for u in json.load(f)["units"] if u["name"] == stack)
    for key, value in res[0]["params"][stack].items():
        assert numpy.array_equal(
            numpy.load(os.path.join(archive, unit[key])), value), key
    assert any(sub.get("vel_ffn_w1", numpy.zeros(0)).shape == (4, 32, 64)
               for sub in state["state"].values())
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
            assert numpy.array_equal(numpy.asarray(value),
                                     state["params"][f.name][key])
    one = groups(2).run("lm_run", config({}), SEED, None, path)[0]
    again = groups(2).run("lm_run", config(parallel), SEED, None, path)[0]
    for got in (one, again):
        assert_trees(res[0]["params"], got["params"], ATOL)


def test_movement_bar_sees_a_skipped_backward_hop(groups):
    """``chip_smoke.py`` holds the card's PP runs against one process by
    each tensor's movement (``PARALLEL_DP_RTOL``, f32). A GPipe run whose
    last stage skips microbatch 0's backward hop of 4 (stage 0 takes
    zeros for it) must read well above that bar, the sound run far
    below."""
    import chip_smoke
    import veles_torch.prng as tprng
    from veles_torch.config import root as troot
    from veles_torch.znicz.models import transformer_lm as tlm
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
    sound = worst(groups(2).run("lm_run", config({"pipe": 2}), SEED)[0]
                  ["params"])
    broken = worst(groups(2).run("lm_run_fault", config({"pipe": 2}), SEED,
                                 "hop")[0]["params"])
    bar = chip_smoke.PARALLEL_DP_RTOL
    assert sound < 1e-3 * bar, (sound, broken)
    assert broken > 2 * bar, (sound, broken)
