"""The port's inference archive (veles_torch/export_inference.py) against
the JAX package's (veles/export_inference.py), on the CPU.

For the MNIST, CIFAR-10, MnistAE (deconv and depooling) and LM samples
(at small data sizes, their widths in full; the LM at its sample width,
dim 64, 2 layers): both
packages are built at one seed, the reference's parameters are imported
into the port (``import_tree``), and each package exports its archive.
The two archives are the same: ``contents.json`` equal as JSON and every
``.npy`` file equal byte for byte. The reference's ``ArchiveModel``
serves the port's archive and its numpy forward equals the port's
training forward (eval mode, f32) within ``TRAIN_FWD_RTOL`` of the
largest output, as does the port's own ``ArchiveModel`` on the CPU. The CLI writes an archive after training; the units the
engines cannot run are refused."""

import copy
import json
import os

import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.serving import ArchiveModel as JaxArchiveModel
from veles.znicz_tpu.models import cifar10 as jcifar
from veles.znicz_tpu.models import mnist as jmnist
from veles.znicz_tpu.models import mnist_ae as jmnist_ae
from veles.znicz_tpu.models import transformer_lm as jlm
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax
from veles_torch.export_inference import unit_spec
from veles_torch.serving import ArchiveModel
from veles_torch.znicz.models import cifar10 as tcifar
from veles_torch.znicz.models import mnist as tmnist
from veles_torch.znicz.models import mnist_ae as tmnist_ae
from veles_torch.znicz.models import transformer_lm as tlm
from veles_torch.znicz.ops.pooling import MaxAbsPooling, StochasticPooling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "veles_torch", "znicz", "models")
#: the reference's numpy serving forward against the port's training
#: forward, as a share of the largest output: f32 sums in other orders
#: (the LM's attention dense on one side, the plain flash version on the
#: other; CIFAR-10's 5×5×32 convolutions an im2col GEMM in numpy, a direct
#: convolution in the port; MnistAE's deconvolution a col2im in numpy, a
#: transposed convolution in the port). Observed: MNIST 4.3e-7, LM 6.0e-7,
#: CIFAR-10 3.0e-6, MnistAE 4.7e-7
TRAIN_FWD_RTOL = {"mnist": 1e-6, "lm": 1e-6, "cifar10": 1e-5,
                  "mnist_ae": 1e-6}
#: each sample at a small data size, its widths in full (the LM's whole
#: config set in both packages: other tests may leave theirs changed)
SAMPLES = {
    "mnist": (jmnist, tmnist, "mnist",
              {"loader": {"minibatch_size": 25, "n_train": 100,
                          "n_valid": 25}}),
    "cifar10": (jcifar, tcifar, "cifar",
                {"loader": {"minibatch_size": 25, "n_train": 50,
                            "n_valid": 25}}),
    "mnist_ae": (jmnist_ae, tmnist_ae, "mnist_ae",
                 {"loader": {"minibatch_size": 25, "n_train": 50,
                             "n_valid": 25}}),
    "lm": (jlm, tlm, "lm",
           {"loader": {"minibatch_size": 16, "n_train": 64, "n_valid": 16,
                       "seq_len": 32, "vocab": 16, "max_period": 6},
            "model": {"dim": 64, "heads": 4, "layers": 2,
                      "ffn_hidden": 128, "attn_block": None,
                      "attn_impl": "pallas", "moe_experts": 0,
                      "stacked": False},
            "parallel": {"seq": 1, "model": 1, "data": 1, "expert": 1,
                         "pipe": 1}}),
}


@pytest.fixture
def configs():
    """Save and restore the samples' config subtrees in both packages."""
    keys = ("mnist", "cifar", "lm", "mnist_ae")
    saved = [(r, k, copy.deepcopy(getattr(r, k).to_dict()))
             for r in (jroot, troot) for k in keys]
    yield
    for r, k, tree in saved:
        getattr(r, k).update(tree)


def jax_params(wf):
    return {u.name: u.export_params() for u in wf.forwards
            if u.export_params()}


def build_pair(sample, seed=1337):
    """(reference workflow on numpy, port workflow on cpu) of ``sample``
    with the reference's parameters imported into the port."""
    jmod, tmod, key, overrides = SAMPLES[sample]
    for r in (jroot, troot):
        for sub, values in overrides.items():
            getattr(getattr(r, key), sub).update(values)
    if key != "lm":
        # the same layer list in both (the port's defaults are the
        # reference's)
        getattr(jroot, key).layers = copy.deepcopy(
            getattr(troot, key).layers)
    jprng.seed_all(seed)
    jw = jmod.create_workflow(name="Export_" + sample)
    jw.initialize(device="numpy")
    tprng.seed_all(seed)
    tw = tmod.create_workflow(name="Export_" + sample)
    tw.initialize(device="cpu")
    tw.import_tree(params_from_jax(jax_params(jw)))
    return jw, tw


def sample_rows(jw, n=8):
    data = numpy.asarray(jw.loader.original_data.mem[:n])
    return data.astype(numpy.float32)


def train_forward(tw, rows):
    """The port's training forward in eval mode (f32 on the CPU)."""
    _, last = tw.step._forward(torch.from_numpy(rows).to(
        tw.forwards[0].weights.device), False)
    return last.float().numpy()


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_archive_equals_reference(configs, tmp_path, sample):
    """From the same weights the port writes the reference's archive:
    contents.json equal as JSON, every .npy the same bytes."""
    jw, tw = build_pair(sample)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jw.export_inference(str(jdir))
    assert tw.export_inference(str(tdir)) == str(tdir / "contents.json")
    want = json.loads((jdir / "contents.json").read_text())
    got = json.loads((tdir / "contents.json").read_text())
    assert got == want
    files = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == files
    assert len(files) > 2
    for name in files:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), \
            name


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_reference_serves_port_archive(configs, tmp_path, sample):
    """The reference's ArchiveModel loads the port's archive; its numpy
    forward equals the port's training forward within TRAIN_FWD_RTOL of
    the largest output, and the port's own ArchiveModel on the CPU
    equals it too."""
    jw, tw = build_pair(sample)
    tw.export_inference(str(tmp_path))
    rows = sample_rows(jw)
    want = train_forward(tw, rows)
    served = JaxArchiveModel.from_dir(str(tmp_path))(rows)
    tol = TRAIN_FWD_RTOL[sample] * numpy.abs(want).max()
    assert numpy.abs(served - want).max() <= tol
    own = ArchiveModel.from_dir(str(tmp_path), device="cpu")(rows)
    assert numpy.abs(own.numpy() - want).max() <= tol


def test_cli_exports_after_training(configs, tmp_path, capsys):
    """``python -m veles_torch mnist.py -d cpu --export-inference DIR``
    prints the reference's line before the final JSON line, and the
    archive serves the trained weights."""
    out = tmp_path / "archive"
    wf = torch_main([os.path.join(MODELS, "mnist.py"),
                     "root.mnist.loader.n_train=200",
                     "root.mnist.loader.n_valid=100",
                     "root.mnist.decision.max_epochs=1", "-d", "cpu",
                     "--seed", "3", "--export-inference", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "inference archive -> %s" % out
    assert json.loads(lines[-1])["device"] == "cpu"
    rows = wf.loader.original_data[:4].astype(numpy.float32)
    served = ArchiveModel.from_dir(str(out), device="cpu")(rows)
    _, last = wf.step._forward(torch.from_numpy(rows), False)
    assert torch.equal(served, last)


@pytest.mark.parametrize("unit,match", [
    (lambda: StochasticPooling(kx=2, ky=2), "C\\+\\+ engine"),
    (lambda: MaxAbsPooling(kx=2, ky=2), "C\\+\\+ engine")],
    ids=["stochastic_pooling", "maxabs_pooling"])
def test_units_without_an_engine_counterpart_are_refused(unit, match):
    with pytest.raises(ValueError, match=match):
        unit_spec(unit())
