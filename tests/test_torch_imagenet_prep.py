"""The port's ImageNet staging tool (veles_torch/znicz/models/
imagenet_prep.py) against the JAX package's
(veles/znicz_tpu/models/imagenet_prep.py) on synthetic archives of the
ILSVRC layout (tests/test_real_data.py): the staged train and validation
trees are byte-equal, a ``.partial`` class is staged again, both refuse an
alphabetically sorted synset list and a ground truth of another length in
the same words, the command lines agree, and the port's ImageNet sample
finds the staged tree."""

import io
import os
import shutil
import tarfile

import numpy
import pytest

from veles.znicz_tpu.models import imagenet_prep as jprep
from veles_torch.config import root as troot
from veles_torch.znicz.models import imagenet as timagenet
from veles_torch.znicz.models import imagenet_prep as tprep

WNIDS = ["n01440764", "n01443537", "n01484850"]
#: the devkit's ILSVRC2012_ID order is not alphabetical
DEVKIT = [WNIDS[1], WNIDS[0], WNIDS[2]]


def _png_bytes(gen):
    from PIL import Image
    img = Image.fromarray(gen.integers(0, 255, (8, 8, 3), dtype=numpy.uint8))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def _add(tar, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tar.addfile(info, io.BytesIO(payload))


@pytest.fixture
def archives(tmp_path):
    """A train tar of per-class tars (2 images each), a flat val tar of 4
    images, its ground truth and both synset lists."""
    gen = numpy.random.Generator(numpy.random.PCG64(1))
    train_tar = tmp_path / "train.tar"
    with tarfile.open(train_tar, "w") as outer:
        for wnid in WNIDS:
            inner_buf = io.BytesIO()
            with tarfile.open(fileobj=inner_buf, mode="w") as inner:
                for i in range(2):
                    _add(inner, "%s_%d.JPEG" % (wnid, i), _png_bytes(gen))
            _add(outer, wnid + ".tar", inner_buf.getvalue())
    val_tar = tmp_path / "val.tar"
    with tarfile.open(val_tar, "w") as tar:
        for i in range(4):
            _add(tar, "ILSVRC2012_val_%08d.JPEG" % (i + 1), _png_bytes(gen))
    labels = tmp_path / "gt.txt"
    labels.write_text("1\n3\n2\n1\n")
    synsets = tmp_path / "synsets.txt"
    synsets.write_text("".join("%s desc %d\n" % (w, i)
                               for i, w in enumerate(DEVKIT)))
    sorted_synsets = tmp_path / "synsets_sorted.txt"
    sorted_synsets.write_text("".join("%s desc\n" % w for w in WNIDS))
    return {"train": str(train_tar), "val": str(val_tar),
            "labels": str(labels), "synsets": str(synsets),
            "sorted": str(sorted_synsets), "dir": tmp_path}


def _tree(base):
    """{relative path: bytes} of every file under ``base``."""
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, base)] = fh.read()
    return out


def _quiet(*args):
    pass


def test_staged_trees_are_byte_equal(archives):
    out = {}
    for tag, prep in (("ref", jprep), ("port", tprep)):
        base = archives["dir"] / tag
        assert prep.stage_train(archives["train"], str(base / "ImageNet"),
                                log=_quiet) == 3
        assert prep.stage_train(archives["train"], str(base / "ImageNet"),
                                log=_quiet) == 0
        assert prep.stage_val(archives["val"], archives["labels"],
                              archives["synsets"],
                              str(base / "ImageNet-val"), log=_quiet) == 4
        out[tag] = (_tree(base / "ImageNet"), _tree(base / "ImageNet-val"))
    assert out["port"] == out["ref"]
    train, val = out["port"]
    assert len(train) == 6 and len(val) == 4
    # ids resolve through the devkit order: id 1 -> DEVKIT[0]
    assert sorted(k for k in val if k.startswith(DEVKIT[0])) == [
        DEVKIT[0] + "/ILSVRC2012_val_00000001.JPEG",
        DEVKIT[0] + "/ILSVRC2012_val_00000004.JPEG"]


def test_partial_class_is_staged_again(archives):
    """An interrupted class (``<wnid>.partial``) is staged again by
    either package, to the same files."""
    trees = {}
    for tag, prep in (("ref", jprep), ("port", tprep)):
        out = archives["dir"] / tag
        prep.stage_train(archives["train"], str(out), log=_quiet)
        shutil.move(str(out / WNIDS[0]), str(out / (WNIDS[0] + ".partial")))
        (out / (WNIDS[0] + ".partial") / (WNIDS[0] + "_1.JPEG")).unlink()
        assert prep.stage_train(archives["train"], str(out),
                                log=_quiet) == 1
        assert len(list((out / WNIDS[0]).iterdir())) == 2
        assert not (out / (WNIDS[0] + ".partial")).exists()
        trees[tag] = _tree(out)
    assert trees["port"] == trees["ref"]


def test_refusals_are_the_references(archives, tmp_path):
    for prep in (jprep, tprep):
        with pytest.raises(ValueError, match="alphabetical order"):
            prep.stage_val(archives["val"], archives["labels"],
                           archives["sorted"], str(tmp_path / "v"),
                           log=_quiet)
    (tmp_path / "gt2.txt").write_text("1\n2\n")
    messages = []
    for prep in (jprep, tprep):
        with pytest.raises(ValueError, match="4 images but") as err:
            prep.stage_val(archives["val"], str(tmp_path / "gt2.txt"),
                           archives["synsets"], str(tmp_path / "w"),
                           log=_quiet)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    # an explicitly allowed sorted list stages
    assert tprep.stage_val(archives["val"], archives["labels"],
                           archives["sorted"], str(tmp_path / "x"),
                           log=_quiet, allow_sorted_synsets=True) == 4


def test_command_lines_agree(archives, capsys):
    trees = {}
    for tag, prep in (("ref", jprep), ("port", tprep)):
        out = archives["dir"] / ("cli_" + tag)
        assert prep.main(["--train-tar", archives["train"],
                          "--val-tar", archives["val"],
                          "--val-labels", archives["labels"],
                          "--synsets", archives["synsets"],
                          "--out", str(out)]) == 0
        trees[tag] = (_tree(out), _tree(str(out) + "-val"))
    assert trees["port"] == trees["ref"]
    assert "train: 3 classes staged" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tprep.main(["--out", str(archives["dir"] / "none")])
    with pytest.raises(SystemExit):
        tprep.main(["--val-tar", archives["val"],
                    "--out", str(archives["dir"] / "none")])


def test_the_sample_finds_the_staged_tree(archives, monkeypatch):
    out = archives["dir"] / "datasets" / "ImageNet"
    tprep.stage_train(archives["train"], str(out), log=_quiet)
    os.makedirs(str(out) + "/n09999999.partial")
    monkeypatch.setattr(troot.common.dirs, "datasets",
                        str(archives["dir"] / "datasets"))
    saved = troot.imagenet.loader.get("base_dir")
    troot.imagenet.loader.base_dir = None
    try:
        assert timagenet._real_tree() == (str(out), 3)
    finally:
        troot.imagenet.loader.base_dir = saved
