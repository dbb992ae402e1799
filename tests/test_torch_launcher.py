"""The port's launcher and CLI (veles_torch/launcher.py,
veles_torch/__main__.py) on the CPU: SIGTERM preemption and ``--snapshot
auto`` in process (a hook sends the signal after an epoch; nothing polls
the file system against a clock), SIGINT, the config-file positional
against the reference CLI's ``--result-file``, ``--dump-config``,
``--profile-dir``'s trace, and the master/slave options of the reference
CLI, each accepted (none is refused any longer); the LM's ``data``,
``seq``, ``model``, ``expert`` and ``pipe`` axes spawn their ranks (the
CLI modes under the axes: tests/test_torch_parallel_cli.py)."""

import json
import logging
import os
import signal

import pytest

from veles.__main__ import main as jax_main
from veles.config import root as jroot
import veles_torch.model_health as TMH
import veles_torch.snapshotter as TS
from veles_torch.__main__ import build_argparser, main as torch_main
from veles_torch.config import root as troot
from veles_torch.launcher import EXIT_PREEMPTED, TRACE_NAME, Launcher
from veles_torch.znicz.standard_workflow import StandardWorkflow

from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from tests.torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models",
                           "mnist.py")
JAX_MNIST = os.path.join(REPO, "veles", "znicz_tpu", "models", "mnist.py")
SMALL = ["root.mnist.loader.n_train=200", "root.mnist.loader.n_valid=50",
         "root.mnist.loader.minibatch_size=50"]
#: a config file's epochs' losses against the reference CLI's (f32 order
#: error over 8 updates)
LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True)
def restore_roots():
    saved = [(getattr(r, k), getattr(r, k).to_dict())
             for r in (jroot, troot) for k in ("mnist", "lm")]
    yield
    for node, tree in saved:
        node.update(tree)


@pytest.fixture
def signal_after_epoch(monkeypatch):
    """-> arm(sig, epoch): the workflow sends ``sig`` to its own process
    once ``epoch`` has ended (the launcher's handler must be in place)."""
    armed = {}
    after = StandardWorkflow._after_decision

    def hooked(self, cls):
        after(self, cls)
        if armed and self.decision.epoch_ended \
                and self.decision.epoch_number == armed["epoch"]:
            sig = armed.pop("sig")
            armed.clear()
            assert signal.getsignal(sig) not in (signal.SIG_DFL,
                                                 signal.SIG_IGN)
            os.kill(os.getpid(), sig)

    monkeypatch.setattr(StandardWorkflow, "_after_decision", hooked)

    def arm(sig, epoch):
        armed.update(sig=sig, epoch=epoch)

    return arm


def _history(path):
    with open(path) as f:
        return json.load(f)["history"]


def test_sigterm_preemption_and_auto_resume(tmp_path, signal_after_epoch,
                                            capsys):
    """SIGTERM after epoch 1 of a 500-epoch run: the run stops before its
    next minibatch, writes a ``current`` checkpoint that verifies and
    exits with EXIT_PREEMPTED; ``--snapshot auto`` resumes it and
    completes, with the history of an uninterrupted run."""
    snaps = str(tmp_path / "snaps")
    base = [TORCH_MNIST, "-d", "cpu", "--seed", "7", "--snapshots", snaps,
            *SMALL]
    before = signal.getsignal(signal.SIGTERM)
    signal_after_epoch(signal.SIGTERM, 2)
    with pytest.raises(SystemExit) as exit_info:
        torch_main(base + ["--checkpoint-every", "3600",
                           "root.mnist.decision.max_epochs=500"])
    assert exit_info.value.code == EXIT_PREEMPTED == 75
    infos = TS.scan_checkpoints(snaps)
    current = [i for i in infos if "_current-" in i.name]
    assert [i.status for i in current] == ["valid"]
    tree = TS.load_snapshot(os.path.join(snaps, current[0].name))
    assert tree["decision"]["epoch_number"] == 2
    assert signal.getsignal(signal.SIGTERM) == before
    resumed = str(tmp_path / "resumed.json")
    torch_main(base + ["--snapshot", "auto", "--result-file", resumed,
                       "root.mnist.decision.max_epochs=3"])
    straight = str(tmp_path / "straight.json")
    torch_main([TORCH_MNIST, "-d", "cpu", "--seed", "7", *SMALL,
                "--result-file", straight, "root.mnist.decision.max_epochs=3"])
    capsys.readouterr()
    assert _history(resumed) == _history(straight)
    assert len(_history(resumed)) == 3


def test_sigint_stops_the_run(tmp_path, signal_after_epoch, capsys):
    """SIGINT after epoch 1 ends the run before its next minibatch, with
    no checkpoint and no exit: the CLI prints its result."""
    before = signal.getsignal(signal.SIGINT)
    signal_after_epoch(signal.SIGINT, 1)
    wf = torch_main([TORCH_MNIST, "-d", "cpu", *SMALL,
                     "root.mnist.decision.max_epochs=5"])
    assert len(wf.decision.history) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["history"]
    assert signal.getsignal(signal.SIGINT) == before


@pytest.fixture
def port_logs(caplog, monkeypatch):
    """caplog that sees the port's records: the CLI's handler stops
    ``veles_torch`` records from propagating to the root logger."""
    monkeypatch.setattr(logging.getLogger("veles_torch"), "propagate", True)
    return caplog


def test_auto_needs_a_store_and_the_cadence_a_snapshotter(port_logs):
    with pytest.raises(ValueError, match="checkpoint location"):
        torch_main([TORCH_MNIST, "-d", "cpu", *SMALL, "--snapshot", "auto",
                    "root.mnist.decision.max_epochs=1"])
    torch_main([TORCH_MNIST, "-d", "cpu", *SMALL, "--checkpoint-every", "1",
                "root.mnist.decision.max_epochs=1"])
    assert "NO interval checkpoints" in port_logs.text


def _config_file(path, package):
    with open(path, "w") as f:
        f.write("from %s.config import root\n"
                "root.mnist.loader.update({'n_train': 200, 'n_valid': 50,\n"
                "                          'minibatch_size': 25})\n"
                "root.mnist.decision.max_epochs = 5\n" % package)
    return str(path)


def test_config_file_equals_the_reference_cli(tmp_path, capsys):
    """A config file (python mutating root) plus overrides after it, the
    same on both CLIs: the same --result-file history (error rates equal,
    losses within LOSS_RTOL); a lone ``a.b=c`` in the config position is
    an override."""
    tail = ["root.mnist.decision.max_epochs=2", "-d", "cpu", "--seed", "11",
            "--result-file"]
    want = str(tmp_path / "want.json")
    jax_main([JAX_MNIST, _config_file(tmp_path / "jcfg.py", "veles"),
              *tail, want, "--no-stats"])
    got = str(tmp_path / "got.json")
    torch_main([TORCH_MNIST, _config_file(tmp_path / "tcfg.py",
                                          "veles_torch"), *tail, got])
    capsys.readouterr()
    jh, th = _history(want), _history(got)
    assert len(jh) == len(th) == 2
    for j, t in zip(jh, th):
        for cls in ("validation", "train"):
            assert j[cls]["metric"] == t[cls]["metric"]
            assert j[cls]["samples"] == t[cls]["samples"] == \
                {"validation": 50, "train": 200}[cls]
            assert abs(j[cls]["loss"] - t[cls]["loss"]) <= \
                LOSS_RTOL * j[cls]["loss"]
    wf = torch_main([TORCH_MNIST, "root.mnist.decision.max_epochs=1", *SMALL,
                     "-d", "cpu", "--dump-config"])
    assert len(wf.decision.history) == 1
    dumped = capsys.readouterr().err
    assert '"max_epochs": 1' in dumped and '"n_train": 200' in dumped


def test_profile_dir_writes_a_trace_of_the_run(tmp_path, capsys):
    """``--profile-dir`` on ``-d cpu``: a torch.profiler Chrome trace in
    the directory that holds the run's operators (the train step's
    matrix products)."""
    prof = str(tmp_path / "prof")
    torch_main([TORCH_MNIST, "-d", "cpu", *SMALL, "--profile-dir", prof,
                "root.mnist.decision.max_epochs=1"])
    capsys.readouterr()
    with open(os.path.join(prof, TRACE_NAME)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "aten::index_select"} <= names, sorted(names)[:20]


#: the reference CLI's master/slave options: (flag, a value, the
#: launcher attribute it sets)
WIRE_FLAGS = (
    ("--listen-address", "127.0.0.1:0", "listen_address"),
    ("--master-address", "127.0.0.1:1", "master_address"),
    ("--slave-timeout", "7.5", "slave_timeout"),
    ("--slave-retries", "3", "slave_options"),
    ("--grad-codec", "int8", "grad_codec"),
    ("--grad-topk-percent", "2.5", "grad_topk_percent"),
    ("--stash-interval", "4", "stash_interval"),
)


@pytest.mark.parametrize("flag,value,attr", WIRE_FLAGS,
                         ids=[u[0] for u in WIRE_FLAGS])
def test_unported_options_name_their_roadmap_item(flag, value, attr,
                                                  monkeypatch):
    """The options the port once refused (naming ROADMAP item 10) are
    ported: each parses and reaches the launcher as the CLI builds it;
    the two that pick a role pick it, the others leave a standalone run
    training."""
    import veles_torch.__main__ as cli
    made = {}

    class Probe(Launcher):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            made["launcher"] = self

        def initialize(self, workflow):
            made["mode"] = self.mode
            if self.mode != "standalone":
                raise SystemExit(0)      # no master or slave to serve
            return super().initialize(workflow)

    monkeypatch.setattr(cli, "Launcher", Probe)
    argv = [TORCH_MNIST, "-d", "cpu", "--no-stats", *SMALL,
            "root.mnist.decision.max_epochs=1", flag, value]
    args = build_argparser().parse_intermixed_args(argv)
    assert getattr(args, flag[2:].replace("-", "_")) is not None
    try:
        wf = torch_main(argv)
    except SystemExit as exc:
        assert exc.code == 0
        wf = None
    launcher = made["launcher"]
    expect = {"--listen-address": "master",
              "--master-address": "slave"}.get(flag, "standalone")
    assert made["mode"] == expect
    got = getattr(launcher, attr)
    if attr == "slave_options":
        assert got == {"max_retries": 3}
    else:
        assert got == type(got)(value)
    if expect == "standalone":
        assert wf.decision.epoch_number == 1


LM_SMALL = ["root.lm.loader.n_train=64", "root.lm.loader.n_valid=32",
            "root.lm.loader.minibatch_size=16", "root.lm.model.dim=32",
            "root.lm.model.ffn_hidden=64", "root.lm.model.layers=1",
            "root.lm.decision.max_epochs=2", "--seed", "1337", "--no-stats"]


def test_lm_parallel_cli_spawns_ranks(tmp_path):
    """``root.lm.parallel.seq=2`` on ``-d cpu``: the CLI spawns 2 ranks
    over gloo; rank 0 writes the result file, whose ``parallel`` names
    the mesh, the transport and the last train step's collectives, and
    whose history is the one-process run's within 1e-5; the process
    returns 0. The card's transports are refused on the CPU."""
    lm = os.path.join(REPO, "veles_torch", "znicz", "models",
                      "transformer_lm.py")
    out = str(tmp_path / "par.json")
    assert torch_main([lm, "-d", "cpu", "root.lm.parallel.seq=2",
                       "--result-file", out] + LM_SMALL) == 0
    with open(out) as f:
        par = json.load(f)
    single = str(tmp_path / "one.json")
    torch_main([lm, "-d", "cpu", "--result-file", single] + LM_SMALL)
    with open(single) as f:
        one = json.load(f)
    assert par["parallel"]["mesh"] == {"seq": 2}
    assert par["parallel"]["transport"] == "gloo"
    assert par["parallel"]["collective_counts"] == {
        "collective-permute": 8, "all-reduce": 1}
    assert par["parallel"]["grad_sync_bytes"] > 0
    got = [h["validation"]["loss"] for h in par["history"]]
    want = [h["validation"]["loss"] for h in one["history"]]
    assert len(got) == 2
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-5, (got, want)
    with pytest.raises(SystemExit, match="-d cpu ranks take gloo"):
        torch_main([lm, "-d", "cpu", "root.lm.parallel.data=2",
                    "--transport", "nccl"])


#: the CLI lines of the expert and pipeline modes (2 ranks each)
EP_PP_LINES = [
    ["root.lm.model.moe_experts=4", "root.lm.parallel.expert=2"],
    ["root.lm.model.moe_experts=4", "root.lm.model.moe_capacity_factor=8.0",
     "root.lm.parallel.expert=2", "root.lm.parallel.ep_routing=alltoall"],
    ["root.lm.model.stacked=True", "root.lm.model.layers=2",
     "root.lm.parallel.pipe=2"],
    ["root.lm.model.stacked=True", "root.lm.model.layers=2",
     "root.lm.parallel.pipe=2", "root.lm.parallel.schedule=1f1b",
     "root.lm.parallel.microbatches=2"]]


@pytest.mark.parametrize("line", EP_PP_LINES,
                         ids=["ep_gather", "ep_alltoall", "pp_gpipe",
                              "pp_1f1b"])
def test_lm_expert_and_pipe_cli_match_one_process(tmp_path, line):
    """``root.lm.parallel.expert=2`` (gather, and all-to-all at a capacity
    no shard overflows) and ``pipe=2`` of the stacked LM (GPipe, 1F1B) on
    ``-d cpu``: the CLI spawns 2 gloo ranks, rank 0's result line names
    the mesh and the mode's collectives, and its history is the
    one-process run's within 1e-5."""
    lm = os.path.join(REPO, "veles_torch", "znicz", "models",
                      "transformer_lm.py")
    out, single = str(tmp_path / "par.json"), str(tmp_path / "one.json")
    assert torch_main([lm, "-d", "cpu", "--result-file", out] + LM_SMALL
                      + line) == 0
    model = [a for a in line if a.startswith("root.lm.model.")]
    torch_main([lm, "-d", "cpu", "--result-file", single] + LM_SMALL + model
               + ["root.lm.parallel.expert=1", "root.lm.parallel.pipe=1"])
    with open(out) as f:
        par = json.load(f)
    with open(single) as f:
        one = json.load(f)
    axis = "expert" if "expert=2" in " ".join(line) else "pipe"
    assert par["parallel"]["mesh"] == {axis: 2}
    counts = par["parallel"]["collective_counts"]
    want = {"expert": ("all-to-all" if "alltoall" in " ".join(line)
                       else "all-gather"),
            "pipe": "collective-permute"}[axis]
    assert counts.get(want) and counts.get("all-reduce"), counts
    got = [h["validation"]["loss"] for h in par["history"]]
    ref = [h["validation"]["loss"] for h in one["history"]]
    assert len(got) == 2
    assert max(abs(a - b) for a, b in zip(got, ref)) <= 1e-5, (got, ref)


def test_lm_parallel_cli_seq_by_model_exports_full_archive(tmp_path):
    """``seq=2`` × ``model=2`` on ``-d cpu`` (4 ranks): the ring owns the
    attention and TP splits the FFN alone (2 all-reduces a layer + the
    gradient bucket); ``--export-inference`` takes every rank into the
    gathers of the FFN's shards and rank 0 writes the archive, which
    holds the full tensors: the one-process run's archive within 1e-5."""
    import numpy
    lm = os.path.join(REPO, "veles_torch", "znicz", "models",
                      "transformer_lm.py")
    out, got_dir = str(tmp_path / "par.json"), str(tmp_path / "par")
    assert torch_main([lm, "-d", "cpu", "root.lm.parallel.seq=2",
                       "root.lm.parallel.model=2", "--result-file", out,
                       "--export-inference", got_dir] + LM_SMALL) == 0
    with open(out) as f:
        par = json.load(f)["parallel"]
    assert par["mesh"] == {"seq": 2, "model": 2}
    assert par["collective_counts"] == {"collective-permute": 8,
                                        "all-reduce": 3}
    want_dir = str(tmp_path / "one")
    torch_main([lm, "-d", "cpu", "--export-inference", want_dir] + LM_SMALL)
    with open(os.path.join(got_dir, "contents.json")) as f:
        doc = json.load(f)
    with open(os.path.join(want_dir, "contents.json")) as f:
        assert doc == json.load(f)
    names = sorted(n for n in os.listdir(want_dir) if n.endswith(".npy"))
    assert names == sorted(n for n in os.listdir(got_dir)
                           if n.endswith(".npy"))
    for name in names:
        got, want = (numpy.load(os.path.join(d, name))
                     for d in (got_dir, want_dir))
        assert got.shape == want.shape, name
        assert numpy.abs(got - want).max() <= 1e-5, name


def test_continual_runs_rounds_on_cpu(tmp_path, capsys):
    """``--continual 2`` of MNIST on ``-d cpu``: two rounds of one epoch
    each (the decision reopened between them, patience disarmed), the
    same --result-file history as the reference CLI's ``--continual 2``
    (error rates equal, losses within LOSS_RTOL)."""
    tail = [*SMALL, "root.mnist.decision.max_epochs=1", "-d", "cpu",
            "--seed", "11", "--continual", "2", "--result-file"]
    want = str(tmp_path / "want.json")
    jax_main([JAX_MNIST, *tail, want, "--no-stats"])
    got = str(tmp_path / "got.json")
    wf = torch_main([TORCH_MNIST, *tail, got])
    capsys.readouterr()
    assert wf.decision.epoch_number == 2 and wf.decision.complete
    assert wf.decision.fail_iterations == float("inf")
    jh, th = _history(want), _history(got)
    assert len(jh) == len(th) == 2
    for j, t in zip(jh, th):
        for cls in ("validation", "train"):
            assert j[cls]["metric"] == t[cls]["metric"]
            assert abs(j[cls]["loss"] - t[cls]["loss"]) <= \
                LOSS_RTOL * j[cls]["loss"]


# -- the model-health plane's options ------------------------------------


class Recording(TMH.ModelHealthMonitor):
    """Counts the layer-stat observations."""

    def __init__(self):
        super().__init__()
        self.observed = 0

    def observe_stats(self, stats, step_index=None):
        self.observed += 1
        super().observe_stats(stats, step_index)


def _health_cli(tmp_path, *flags):
    """One MNIST epoch (4 train steps) with a snapshotter."""
    return torch_main([TORCH_MNIST, "-d", "cpu", *SMALL,
                       "root.mnist.decision.max_epochs=1",
                       "--snapshots", str(tmp_path), *flags])


@pytest.mark.parametrize("flags,observed", [((), 1),
                                            (("--stats-interval", "1"), 4),
                                            (("--stats-interval", "3"), 2)])
def test_stats_interval_reaches_the_step(tmp_path, flags, observed):
    """The stats are on by default at stride 8; ``--stats-interval``
    sets the step's stride; the checkpoint is stamped ``healthy``."""
    with TMH.scoped(Recording()) as monitor:
        wf = _health_cli(tmp_path, *flags)
    assert wf.step.collect_model_stats and monitor.observed == observed
    assert wf.step.stats_interval == (int(flags[1]) if flags else 8)
    assert [i.health_verdict for i in TS.scan_checkpoints(
        str(tmp_path))] == ["healthy"]


def test_model_stats_off_stands_the_plane_down(tmp_path):
    """``--model-stats off``: no stats, a disabled monitor, checkpoints
    stamped ``unknown``."""
    with TMH.scoped() as monitor:
        wf = _health_cli(tmp_path, "--model-stats", "off")
        assert not monitor.enabled and not wf.step.collect_model_stats
        assert monitor.snapshot()["layers"] == {}
    assert [i.health_verdict for i in TS.scan_checkpoints(
        str(tmp_path))] == ["unknown"]


def test_rollback_on_divergence_arms_the_rollback(tmp_path, port_logs,
                                                  monkeypatch):
    """A workflow without a rollback gets the reference's warning and
    runs on; one with a rollback has it armed."""
    wf = _health_cli(tmp_path, "--rollback-on-divergence")
    assert wf.rollback is None and wf.decision.epoch_number == 1
    assert "no rollback unit" in port_logs.text
    initialize = StandardWorkflow.initialize

    def with_rollback(self, *args, **kwargs):
        self.link_rollback()
        return initialize(self, *args, **kwargs)

    monkeypatch.setattr(StandardWorkflow, "initialize", with_rollback)
    wf = _health_cli(tmp_path / "b", "--rollback-on-divergence")
    assert wf.rollback.rollback_on_divergence
