"""SIGTERM across the ranks of a parallel run (veles_torch/znicz/parallel
``spawn``, ``TorchStep.stop_agreed``, launcher.py's preemption exit) on 2
gloo ranks of this host, through the CLI: the spawner forwards the
signal, the ranks stop before the same minibatch of epoch 1's train
class, rank 0 writes the one preemption checkpoint, every rank and the
spawner exit 75, and ``--snapshot auto`` in a fresh spawn under the same
axes finishes the run bit for bit as the uninterrupted one (every
parameter of the gathered archive, the decision's history)."""

import copy
import json
import os

import numpy
import pytest

from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.launcher import EXIT_PREEMPTED
from veles_torch.znicz import parallel
from tests.torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = os.path.join(REPO, "veles_torch", "znicz", "models",
                  "transformer_lm.py")
LINE = ["-d", "cpu", "root.lm.parallel.data=2", "root.lm.loader.n_train=64",
        "root.lm.loader.n_valid=32", "root.lm.loader.minibatch_size=16",
        "root.lm.model.dim=32", "root.lm.model.ffn_hidden=64",
        "root.lm.model.layers=1", "root.lm.decision.max_epochs=3",
        "--seed", "1337", "--no-stats"]

#: the config file of run B: rank 0 signals the spawner (its parent) after
#: the 2nd train step of epoch 1, then waits for its own forwarded signal,
#: so the ranks agree on the next minibatch
HOOK = '''
import os, signal, time
from veles_torch.znicz.step import TorchStep
if os.environ.get("RANK") == "0":
    _train = TorchStep.train_minibatch

    def _preempting(step, *args):
        out = _train(step, *args)
        if step.decision.epoch_number == 1 and step.entry is not None \\
                and step.train_steps == step.entry["step_index"] + 2:
            with open(os.environ["PREEMPT_MARK"], "w") as f:
                f.write(str(step.train_steps))
            os.kill(os.getppid(), signal.SIGTERM)
            deadline = time.monotonic() + 60
            while not step.stop_requested and time.monotonic() < deadline:
                time.sleep(0.01)
        return out
    TorchStep.train_minibatch = _preempting
'''


@pytest.fixture(autouse=True)
def lm_config():
    """The port's root.lm, put back after each test (the CLI's overrides
    land in this process's root too)."""
    saved = copy.deepcopy(troot.lm.to_dict())
    yield
    troot.lm.update(saved)


def _run(tmp_path, tag, *extra, config=None):
    out = str(tmp_path / ("%s.json" % tag))
    archive = str(tmp_path / ("%s_archive" % tag))
    argv = [LM] + ([config] if config else []) + LINE + [
        "--result-file", out, "--export-inference", archive, *extra]
    code = torch_main(argv)
    result = None
    if os.path.exists(out):
        with open(out) as f:
            result = json.load(f)
    return code, result, archive


def test_exit_code_is_the_launchers():
    assert parallel.EXIT_PREEMPTED == EXIT_PREEMPTED == 75


def test_sigterm_checkpoints_once_and_auto_resumes_bit_for_bit(
        tmp_path, monkeypatch):
    """Run A trains 3 epochs under ``data=2``; run B gets the SIGTERM 2
    steps into epoch 1: the spawner returns 75 (each rank exited 75), the
    store holds exactly one preemption checkpoint (the ``current`` slot,
    rank 0's) beside the best ones, taken at the epoch's entry; B
    resumed by ``--snapshot auto`` equals A bit for bit."""
    # the ranks' products the same bits run to run whatever the host's
    # load: MKL's code path fixed, its thread count too (each CPU rank
    # runs cores/ranks threads)
    monkeypatch.setenv("MKL_CBWR", "COMPATIBLE")
    monkeypatch.setenv("MKL_DYNAMIC", "FALSE")
    code, a, a_dir = _run(tmp_path, "a", "--snapshots",
                          str(tmp_path / "a_snaps"))
    assert code == 0 and len(a["history"]) == 3
    hook = tmp_path / "preempt_hook.py"
    hook.write_text(HOOK)
    mark = tmp_path / "mark"
    monkeypatch.setenv("PREEMPT_MARK", str(mark))
    snaps = str(tmp_path / "b_snaps")
    code, b, _ = _run(tmp_path, "b", "--snapshots", snaps,
                      config=str(hook))
    assert code == EXIT_PREEMPTED
    assert b is None            # stopped before its result line
    assert int(mark.read_text()) == 4 + 2   # epoch 0's 4 steps, then 2
    names = sorted(os.listdir(snaps))
    current = [n for n in names if "_current-" in n]
    assert len(current) == 1, names
    import veles_torch.snapshotter as TS
    tree, name, _ = TS.resolve_auto(snaps)
    assert name == current[0]
    assert tree["decision"]["epoch_number"] == 1
    code, resumed, b_dir = _run(tmp_path, "resumed", "--snapshots", snaps,
                                "--snapshot", "auto:" + snaps)
    assert code == 0
    assert resumed["history"] == a["history"]
    files = sorted(f for f in os.listdir(a_dir) if f.endswith(".npy"))
    assert files and files == sorted(f for f in os.listdir(b_dir)
                                     if f.endswith(".npy"))
    for f in files:
        numpy.testing.assert_array_equal(numpy.load(os.path.join(b_dir, f)),
                                         numpy.load(os.path.join(a_dir, f)))


@pytest.mark.parametrize("flags,want", [((0, 0), (False, False)),
                                        ((1, 0), (True, False)),
                                        ((0, 1), (True, True))],
                         ids=["none", "stop", "preempt"])
def test_stop_flags_are_agreed_by_sum(monkeypatch, flags, want):
    """The (stop, preempt) flags summed over the ranks by one host
    all-reduce a minibatch (host tensors: no card work to wait for),
    here with the other rank's flags ``flags``: any rank's stop stops
    every rank, a preemption anywhere is every rank's."""
    import torch
    from veles_torch.znicz.parallel import collectives
    from veles_torch.znicz.step import TorchStep
    seen = []

    def all_reduce_host(tensor, mesh):
        seen.append(tensor.device.type)
        other = torch.tensor([float(flags[0] or flags[1]), float(flags[1])])
        return tensor + other
    monkeypatch.setattr(collectives, "all_reduce_host", all_reduce_host)
    step = TorchStep.__new__(TorchStep)
    step.stop_requested, step.preempt_requested = False, False
    step.mesh = type("M", (), {"axis_names": ("data",),
                               "axis_size": lambda self, axes: 2})()
    step.stop_flag_reduces, step.stop_flag_seconds = 0, 0.0
    assert step.stop_agreed() == want[0]
    assert step.preempt_requested == want[1]
    assert step.stop_requested == want[0]
    assert step.stop_flag_reduces == 1 and seen == ["cpu"]
