"""The port's Tune config leaves and genetic search
(veles_torch/config.py, veles_torch/genetics.py, ``--optimize``) against
the JAX package's (veles/config.py, veles/genetics.py) on the CPU: the
same trees give the same reads, raw leaves, flattened paths and
tunables; find_tunables and apply_values the same paths and values; the
GeneticOptimizer on the same deterministic functions and seeds the same
history, champion and evaluation count, bit for bit; the search over a
mistuned MNIST the same champion history, each fitness within one
validation sample of the reference's; and the CLI's in-process and
worker-process searches the same report."""

import copy
import json
import math
import os
import subprocess
import sys

import numpy
import pytest

import veles.genetics as JG
import veles.prng as jprng
from veles.config import Config as JConfig
from veles.config import Tune as JTune
from veles.config import root as jroot
from veles.znicz_tpu.models import mnist as jmnist
import veles_torch.genetics as TG
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import Config as TConfig
from veles_torch.config import Tune as TTune
from veles_torch.config import root as troot
from veles_torch.znicz.models import mnist as tmnist

from tests.torch_monitor import port_model_health_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models", "mnist.py")
JAX_MNIST = os.path.join(REPO, "veles", "znicz_tpu", "models", "mnist.py")
#: the MNIST search's fitness is a validation error over 80 samples: the
#: port's may differ from the reference's by at most one sample's share
MNIST_GA = {"n_train": 200, "n_valid": 80, "minibatch_size": 40}
ONE_SAMPLE = 1.0 / MNIST_GA["n_valid"]
#: the config file of the CLI searches (the reference test's)
GA_CONFIG = (
    "from {pkg}.config import root, Tune\n"
    "for layer in root.mnist.layers:\n"
    "    if '<-' in layer:\n"
    "        layer['<-']['learning_rate'] = Tune(0.02, 0.005, 0.1)\n")
CLI_SMALL = ("root.mnist.loader.n_train=120", "root.mnist.loader.n_valid=40",
             "root.mnist.loader.minibatch_size=40",
             "root.mnist.decision.max_epochs=1")


def build_tree(Config, Tune):
    """One tree in a package's Config: Tune leaves on a node, in a dict
    and in a layer list, plain leaves beside them."""
    cfg = Config("t")
    cfg.update({"layer": {"lr": Tune(0.1, 0.001, 1.0), "plain": 3},
                "width": Tune(64, 16, 256)})
    cfg.layers = [{"->": {"n": 10}, "<-": {"lr": Tune(0.2, 0.01, 0.5),
                                           "moment": 0.9}},
                  {"->": {"n": Tune(7, 2, 9)}}]
    cfg.flag = Tune(True, False, True)
    return cfg


def tune_tuple(t):
    return (type(t).__name__, t.default, t.min_value, t.max_value,
            t.discrete)


def leaf(value):
    return tune_tuple(value) if isinstance(value, (JTune, TTune)) \
        else value


def test_tune_reads_raw_flatten_and_tunables_match_reference():
    """Reads resolve a Tune to its default, ``raw`` returns the leaf,
    ``flatten``/``tunables``/``to_dict`` give the same paths and values
    in both packages, and an override replaces a Tune leaf in both."""
    ref, port = build_tree(JConfig, JTune), build_tree(TConfig, TTune)
    for cfg in (ref, port):
        assert cfg.layer.lr == 0.1 and cfg.width == 64
        assert cfg.get("width") == 64 and cfg.flag is True
        assert cfg.layer.get("missing", "d") == "d"
    assert tune_tuple(port.raw("width"))[1:] == \
        tune_tuple(ref.raw("width"))[1:] == (64, 16, 256, True)
    assert tune_tuple(port.layer.raw("lr"))[1:] == \
        tune_tuple(ref.layer.raw("lr"))[1:] == (0.1, 0.001, 1.0, False)
    # a bool is not an int: the flag is a continuous leaf in both
    assert port.raw("flag").discrete is ref.raw("flag").discrete is False
    rf, pf = ref.flatten(), port.flatten()
    assert sorted(rf) == sorted(pf)
    assert {k: leaf(v)[1:] if isinstance(v, (JTune, TTune)) else v
            for k, v in rf.items() if not isinstance(v, list)} == \
        {k: leaf(v)[1:] if isinstance(v, (JTune, TTune)) else v
         for k, v in pf.items() if not isinstance(v, list)}
    assert sorted(ref.tunables()) == sorted(port.tunables()) == \
        ["flag", "layer.lr", "width"]
    assert sorted(ref.tunables("root")) == sorted(port.tunables("root"))
    assert json.dumps(ref.to_dict(), sort_keys=True, default=str) == \
        json.dumps(port.to_dict(), sort_keys=True, default=str)
    for cfg in (ref, port):
        cfg.apply_override("t.layer.lr=0.5")
        cfg.apply_override("width=32")
        assert cfg.layer.lr == 0.5 and cfg.raw("width") == 32
    assert sorted(ref.tunables()) == sorted(port.tunables()) == ["flag"]


@pytest.mark.parametrize("bounds,values", [
    ((4, 2, 16), (-3.0, 2.4, 8.5, 9.5, 15.6, 40.0)),
    ((0.1, 0.001, 1.0), (-1.0, 0.0005, 0.25, 0.999, 3.0)),
    ((5, 0.0, 10), (4.6, -2.0, 11.0)),
])
def test_tune_clip_matches_reference(bounds, values):
    """``clip`` bounds and rounds as the reference's: discrete when the
    default and both ends are ints."""
    ref, port = JTune(*bounds), TTune(*bounds)
    assert port.discrete == ref.discrete
    for v in values:
        got, want = port.clip(v), ref.clip(v)
        assert got == want and type(got) is type(want), (v, got, want)


def test_find_tunables_and_apply_values_match_reference():
    """The reference test's tree and the wider one of
    ``build_tree``: the same ``/`` paths, and apply_values writes the same
    values into the Config nodes, dicts and lists of both."""
    for build in (
            lambda C, T: C("test_ga").update(
                {"layer": {"lr": T(0.1, 0.001, 1.0)}}),
            build_tree):
        ref, port = build(JConfig, JTune), build(TConfig, TTune)
        if "layers" not in ref:
            ref.layers = [{"<-": {"lr": JTune(0.2, 0.01, 0.5)}}]
            port.layers = [{"<-": {"lr": TTune(0.2, 0.01, 0.5)}}]
        rt, pt = JG.find_tunables(ref), TG.find_tunables(port)
        assert sorted(rt) == sorted(pt)
        assert {k: tune_tuple(v)[1:] for k, v in rt.items()} == \
            {k: tune_tuple(v)[1:] for k, v in pt.items()}
        values = {path: t.clip(t.max_value) for path, t in pt.items()}
        JG.apply_values(ref, values)
        TG.apply_values(port, values)
        assert JG.find_tunables(ref) == {} == TG.find_tunables(port)
        assert ref.to_dict() == port.to_dict()
        assert port.layers[0]["<-"]["lr"] == 0.5


def _quadratic(v):
    return (v["a"] - 2.0) ** 2 + (v["b"] - 7.0) ** 2


def _discrete(v):
    return abs(v["n"] - 9)


def _failing(v):
    if v["x"] < 0:
        raise RuntimeError("diverged")
    return v["x"]


#: the reference test's three searches (tests/test_genetics_ensemble.py)
SEARCHES = {
    "quadratic": (_quadratic, {"a": (5.0, -10.0, 10.0),
                               "b": (-3.0, -10.0, 10.0)},
                  dict(population_size=16, generations=12, seed=3)),
    "discrete": (_discrete, {"n": (4, 2, 16)},
                 dict(population_size=12, generations=8, seed=1)),
    "failing": (_failing, {"x": (0.0, -1.0, 1.0)},
                dict(population_size=8, generations=3, seed=2)),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_genetic_optimizer_search_equals_reference(case):
    """Same function, tunables and seed: equal history (every champion's
    fitness and values), best values and fitness, evaluation count and
    the individuals' values in evaluation order; the reference test's
    assertions hold on the port's result."""
    fn, spans, kwargs = SEARCHES[case]
    runs = {}
    for name, G, Tune in (("ref", JG, JTune), ("port", TG, TTune)):
        seen = []

        def evaluate(v):
            seen.append(dict(v))
            return fn(v)

        opt = G.GeneticOptimizer(
            evaluate, {k: Tune(*s) for k, s in spans.items()}, **kwargs)
        best, fitness = opt.run()
        runs[name] = (opt.history, best, fitness, opt.evaluations, seen)
    assert runs["port"] == runs["ref"]
    _, best, fitness, evaluations, seen = runs["port"]
    if case == "quadratic":
        assert fitness < 0.5 and abs(best["a"] - 2.0) < 0.6 \
            and abs(best["b"] - 7.0) < 0.6
    elif case == "discrete":
        assert all(isinstance(n, int) and 2 <= n <= 16 for n in
                   (v["n"] for v in seen))
        assert best["n"] == 9 and fitness == 0
    else:
        assert numpy.isfinite(fitness) and best["x"] >= 0
        assert any(v["x"] < 0 for v in seen)
    assert evaluations == len(seen)


def test_failed_individual_scores_inf_with_its_error():
    """``_SafeEval`` returns what the reference's does: the fitness, or
    inf and the exception's type and text."""
    for G in (JG, TG):
        assert G._SafeEval(_failing)({"x": 0.25}) == (0.25, None)
        assert G._SafeEval(_failing)({"x": -0.5}) == (
            math.inf, "RuntimeError: diverged")


def test_worker_without_a_card_fails_its_individual(tmp_path):
    """``SubprocessTrainer`` on ``cuda`` where there is no card: the
    individual fails in the open (inf and the error's text), nothing
    trains on the CPU in its place, and the tree it reset is the
    sample's."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = tmp_path / "ga_config.py"
    cfg.write_text(GA_CONFIG.format(pkg="veles_torch"))
    trainer = TG.SubprocessTrainer(TORCH_MNIST, str(cfg),
                                   overrides=CLI_SMALL, seed=5)
    assert trainer.device == "cuda"
    try:
        fitness, error = TG._SafeEval(trainer)(
            {"mnist/layers/0/<-/learning_rate": 0.05})
    finally:
        _restore_sample()
    assert fitness == math.inf
    assert error is not None and "cuda" in error.lower(), error


def test_config_file_with_tune_leaves_trains_at_the_defaults(tmp_path):
    """A plain run (no search) of a config file that marks both learning
    rates ``Tune(0.02, ...)`` and the hidden width ``Tune(100, ...)``
    trains as the sample's own values do: the layer builder reads each
    Tune leaf's default, in the forward and the gradient kwargs."""
    cfg = tmp_path / "ga_config.py"
    cfg.write_text(GA_CONFIG.format(pkg="veles_torch")
                   + "root.mnist.layers[0]['->']['output_sample_shape'] = "
                     "Tune(100, 50, 200)\n")
    argv = [TORCH_MNIST, *CLI_SMALL, "-d", "cpu", "--seed", "5"]
    try:
        plain = torch_main(argv)
        tuned = torch_main(argv[:1] + [str(cfg)] + argv[1:])
        assert len(TG.find_tunables(troot)) == 3
    finally:
        _restore_sample()
    assert tuned.gds[0].learning_rate == plain.gds[0].learning_rate == 0.02
    assert tuple(tuned.forwards[0].weights.shape) == (784, 100)
    assert tuned.decision.history == plain.decision.history


def _restore_sample():
    """Re-run the port sample's defaults into ``root`` (the search wrote
    values into the layer dicts in place)."""
    from veles_torch.__main__ import import_file
    import_file(TORCH_MNIST, "veles_torch_mnist_defaults")


@pytest.fixture
def mistuned_mnist():
    """Both packages' ``root.mnist`` at MNIST_GA's sizes, 2 epochs, every
    learning rate ``Tune(1e-4, 1e-4, 0.1)``; restored after."""
    saved = []
    for r, Tune in ((jroot, JTune), (troot, TTune)):
        saved.append((r, copy.deepcopy(r.mnist.layers),
                      {k: r.mnist.loader.get(k) for k in MNIST_GA},
                      r.mnist.decision.max_epochs))
        r.mnist.loader.update(MNIST_GA)
        r.mnist.decision.max_epochs = 2
        for layer in r.mnist.layers:
            layer["<-"]["learning_rate"] = Tune(1e-4, 1e-4, 0.1)
    yield
    for r, layers, loader, epochs in saved:
        r.mnist.layers = layers
        r.mnist.loader.update(loader)
        r.mnist.decision.max_epochs = epochs
    assert TG.find_tunables(troot) == {}


def test_mnist_search_equals_reference(mistuned_mnist):
    """``optimize_config`` over the mistuned MNIST (population 5, 2
    generations, seed 9; every run from seed 1234): the port on the CPU
    and the reference on numpy give the same champion values generation
    by generation, each fitness within ONE_SAMPLE of the reference's,
    the same evaluation count; the search beats the mistuned default by
    5 points in both, and the best values end up in each tree."""

    def run_ref():
        jprng.seed_all(1234)
        wf = jmnist.create_workflow(name="GAMnist")
        wf.initialize(device="numpy")
        wf.run()
        return float(wf.decision.best_metric)

    def run_port():
        tprng.seed_all(1234)
        wf = tmnist.create_workflow(name="GAMnist")
        wf.initialize(device="cpu")
        wf.run()
        return float(wf.decision.best_metric)

    baseline = (run_ref(), run_port())
    assert abs(baseline[0] - baseline[1]) <= ONE_SAMPLE
    search = dict(population_size=5, generations=2, seed=9)
    ref = JG.optimize_config(jroot.mnist, run_ref, **search)
    port = TG.optimize_config(troot.mnist, run_port, **search)
    assert port.evaluations == ref.evaluations == 5 + 2 * 3
    assert [v for _, v in port.history] == [v for _, v in ref.history]
    for (fp, _), (fr, _) in zip(port.history, ref.history):
        assert abs(fp - fr) <= ONE_SAMPLE + 1e-12
    assert port.best_values == ref.best_values
    assert abs(port.best_fitness - ref.best_fitness) <= ONE_SAMPLE + 1e-12
    for opt, base in zip((ref, port), baseline):
        assert opt.best_fitness < base - 0.05, (opt.best_fitness, base)
    for path, value in port.best_values.items():
        layer = int(path.split("/")[1])
        assert troot.mnist.layers[layer]["<-"]["learning_rate"] == value
        assert jroot.mnist.layers[layer]["<-"]["learning_rate"] == value


def _cli(pkg, tmp_path, *args):
    """``python -m <pkg>`` on the MNIST sample with the GA config file and
    CLI_SMALL in a child process (the search writes into root); -> the
    parsed last stdout line."""
    cfg = tmp_path / ("ga_config_%s.py" % pkg)
    cfg.write_text(GA_CONFIG.format(pkg=pkg))
    sample = TORCH_MNIST if pkg == "veles_torch" else JAX_MNIST
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", pkg, sample, str(cfg), *CLI_SMALL,
         "--seed", "5", *args], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cli_optimize_workers_equal_in_process_and_reference(tmp_path):
    """``--optimize 1x3`` in process and ``1x3x2`` in two spawned workers
    give the same best fitness, values and evaluation count (the worker
    report also names its workers), and the reference CLI's numpy search
    the same values and counts, its fitness within one of its 40
    validation samples; ``--result-file`` holds the printed report."""
    result = tmp_path / "ga.json"
    seq = _cli("veles_torch", tmp_path, "-d", "cpu", "--optimize", "1x3",
               "--result-file", str(result))
    par = _cli("veles_torch", tmp_path, "-d", "cpu", "--optimize", "1x3x2")
    assert json.loads(result.read_text()) == seq
    assert par.pop("workers") == 2
    assert par == seq
    assert seq["evaluations"] == 4 and numpy.isfinite(seq["best_fitness"])
    assert sorted(seq["best_values"]) == [
        "mnist/layers/0/<-/learning_rate", "mnist/layers/1/<-/learning_rate"]
    ref = _cli("veles", tmp_path, "-d", "numpy", "--no-stats",
               "--optimize", "1x3")
    assert ref["best_values"] == seq["best_values"]
    assert ref["evaluations"] == seq["evaluations"]
    assert abs(ref["best_fitness"] - seq["best_fitness"]) <= 1 / 40 + 1e-12


def test_parallel_generation_scores_as_sequential(tmp_path):
    """The reference test's check on the port: a search whose individuals
    run in ProcessPoolMap workers (``SubprocessTrainer`` on the CPU)
    equals the same search run one individual after the other in this
    process, champion for champion."""
    cfg = tmp_path / "ga_config.py"
    cfg.write_text(GA_CONFIG.format(pkg="veles_torch")
                   + "".join("root.%s\n" % o.split("root.", 1)[1]
                             for o in CLI_SMALL))
    from veles_torch.__main__ import import_file
    try:
        import_file(TORCH_MNIST, "ga_wf_probe")
        import_file(str(cfg), "ga_cfg_probe")
        tunables = TG.find_tunables(troot)
        assert sorted(tunables) == [
            "mnist/layers/0/<-/learning_rate",
            "mnist/layers/1/<-/learning_rate"]

        def search(map_fn):
            evaluate = TG.SubprocessTrainer(TORCH_MNIST, str(cfg), seed=5,
                                            device="cpu")
            opt = TG.GeneticOptimizer(
                evaluate, dict(tunables), generations=1, population_size=3,
                elite=1, seed=5, map_fn=map_fn)
            opt.run()
            return opt

        seq = search(None)
        with TG.ProcessPoolMap(2) as pool:
            par = _bounded(lambda: search(pool))
    finally:
        _restore_sample()
    assert seq.evaluations == par.evaluations == 5
    assert numpy.isfinite(par.best_fitness)
    assert seq.history == par.history
    assert (seq.best_fitness, seq.best_values) == \
        (par.best_fitness, par.best_values)


def test_finished_individual_leaves_no_workflow_alive(tmp_path,
                                                     monkeypatch):
    """After ``SubprocessTrainer`` returns, nothing of the run is left for
    the collector: a workflow and its units refer to each other, and
    each dead run would otherwise hold its tensors (on the card, its
    device data) into the next individual."""
    import weakref
    from veles_torch.znicz import standard_workflow as SW
    made = []
    init = SW.StandardWorkflow.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(weakref.ref(self))

    monkeypatch.setattr(SW.StandardWorkflow, "__init__", recording)
    cfg = tmp_path / "ga_config.py"
    cfg.write_text(GA_CONFIG.format(pkg="veles_torch"))
    trainer = TG.SubprocessTrainer(TORCH_MNIST, str(cfg),
                                   overrides=CLI_SMALL, seed=5, device="cpu")
    try:
        for lr in (0.01, 0.05):
            assert numpy.isfinite(
                trainer({"mnist/layers/0/<-/learning_rate": lr}))
            assert [r() for r in made] == [None] * len(made)
    finally:
        _restore_sample()
    assert len(made) == 2


def _bounded(fn, timeout=240):
    """``fn()`` on a thread, waited for at most ``timeout`` seconds: a
    test of the worker pool fails, it does not hang. -> its result."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:   # handed to the test below
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the worker pool did not answer in %d s" \
        % timeout
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_workers_share_the_host_cores():
    """Each ProcessPoolMap worker runs torch on its share of the host's
    cores (without it, every worker takes them all and the pools spin
    against each other)."""
    from tests.torch_workers import torch_threads
    cores = len(os.sched_getaffinity(0))
    with TG.ProcessPoolMap(2) as pool:
        got = _bounded(lambda: pool(torch_threads, range(4)))
    assert got == [max(1, cores // 2)] * 4


def test_a_dead_worker_ends_the_search_in_the_open():
    """A worker that dies mid-individual (no exception to catch: the
    process is gone) ends the search with BrokenProcessPool; the
    reference's pool would wait for it forever."""
    from concurrent.futures.process import BrokenProcessPool
    from tests.torch_workers import die
    opt = TG.GeneticOptimizer(die, {"x": TTune(0.0, -1.0, 1.0)},
                              population_size=4, generations=1, seed=1)
    with TG.ProcessPoolMap(2) as pool:
        opt.map_fn = pool
        with pytest.raises(BrokenProcessPool):
            _bounded(opt.run)


@pytest.mark.parametrize("argv", [
    ["--optimize", "slave"],
    ["--optimize", "2x4", "--listen-address", "127.0.0.1:0"],
    ["--optimize", "2x4", "--master-address", "127.0.0.1:1"],
], ids=["slave", "listen-address", "master-address"])
def test_distributed_search_names_item_10(argv):
    """The search over registered slaves rides the master/slave wire:
    refused, naming ROADMAP Queue 1 item 10, before anything trains."""
    with pytest.raises(NotImplementedError, match=r"item 10\)"):
        torch_main([TORCH_MNIST, "-d", "cpu", *argv])
    assert TG.find_tunables(troot) == {}
