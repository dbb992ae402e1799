"""ImageNet staging tool of the PyTorch port: raw distribution archives
-> the class-dir tree the image loader ingests.

The port's own copy of ``veles/znicz_tpu/models/imagenet_prep.py`` (the
same functions, flags and refusals; the staged trees are byte-equal).

The reference's ImageNet sample assumed a prepared directory layout
(SURVEY.md §2.3 "ImageNet pipeline"); the raw ILSVRC distribution is
not shaped like that — train images arrive as one tar of per-class
tars, validation as a flat image directory plus a ground-truth label
list. This tool builds the ``<base>/<wnid>/*.JPEG`` tree that
``AutoLabelFileImageLoader`` (``veles_torch/loader/image.py``) and
``models/imagenet.py`` pick up with zero config (see ``_real_tree``):

    python -m veles_torch.znicz.models.imagenet_prep \
        --train-tar ILSVRC2012_img_train.tar \
        --val-tar ILSVRC2012_img_val.tar \
        --val-labels ILSVRC2012_validation_ground_truth.txt \
        --synsets devkit_ilsvrc2012_id_order.txt \
        --out $DATASETS/ImageNet

WARNING on --synsets ordering: the ground-truth file's class ids follow
the devkit's ILSVRC2012_ID ordering (meta.mat / meta_clsloc), which is
NOT the wnid-sorted line order of the commonly distributed
``synset_words.txt``. Passing a wnid-sorted list silently stages every
validation image under the wrong class — the ids all range-check fine.
Derive the list from the devkit (line N = wnid whose ILSVRC2012_ID is
N); ``stage_val`` refuses alphabetically-sorted synset lists unless
``allow_sorted_synsets=True`` (``--allow-sorted-synsets``).

Runs incrementally (already-extracted classes are skipped), so an
interrupted staging resumes. Extraction uses streaming tarfile reads —
no tar is ever fully loaded into memory. The port decodes the staged
JPEG files itself (``veles_torch/loader/jpeg.py``)."""

import argparse
import os
import sys
import tarfile


def stage_train(train_tar, out_dir, log=print):
    """Outer tar of per-class tars -> ``out/<wnid>/*``; returns the
    number of classes staged (skips classes already present).

    Atomic per class: each class extracts into ``<wnid>.partial`` and
    renames into place only when complete, so an interrupted run never
    leaves a truncated class that a resume would silently skip."""
    os.makedirs(out_dir, exist_ok=True)
    staged = 0
    with tarfile.open(train_tar) as outer:
        for member in outer:
            if not member.isfile() or not member.name.endswith(".tar"):
                continue
            wnid = os.path.splitext(os.path.basename(member.name))[0]
            cls_dir = os.path.join(out_dir, wnid)
            if os.path.isdir(cls_dir):
                continue                      # complete (rename is last)
            tmp_dir = cls_dir + ".partial"
            if os.path.isdir(tmp_dir):        # leftover from a kill
                for f in os.listdir(tmp_dir):
                    os.unlink(os.path.join(tmp_dir, f))
            os.makedirs(tmp_dir, exist_ok=True)
            inner_f = outer.extractfile(member)
            with tarfile.open(fileobj=inner_f) as inner:
                for img in inner:
                    if not img.isfile():
                        continue
                    name = os.path.basename(img.name)
                    with open(os.path.join(tmp_dir, name), "wb") as w:
                        w.write(inner.extractfile(img).read())
            os.rename(tmp_dir, cls_dir)
            staged += 1
            log("staged class %s" % wnid)
    return staged


def stage_val(val_tar, labels_file, synsets_file, out_dir, log=print,
              allow_sorted_synsets=False):
    """Flat validation tar + ground-truth ILSVRC ids + synset list ->
    the same ``out/<wnid>/`` layout (so train and val trees load with
    the same class mapping); returns images staged.

    ``labels_file``: one 1-based ILSVRC class id per line, in the
    sorted-filename order of the archive. ``synsets_file``: one
    ``wnid ...description`` per line, line N = the wnid whose devkit
    ILSVRC2012_ID is N (meta.mat ordering — NOT the wnid-sorted order
    of the common ``synset_words.txt``; see the module docstring).

    Because a wrongly-ordered synset list still range-checks, an
    alphabetically-sorted wnid list — the signature of the wnid-sorted
    ``synset_words.txt`` — is rejected unless ``allow_sorted_synsets``
    (the devkit ILSVRC2012_ID order is not alphabetical)."""
    with open(synsets_file) as f:
        wnids = [line.split()[0] for line in f if line.strip()]
    if len(wnids) > 2 and wnids == sorted(wnids) and not allow_sorted_synsets:
        raise ValueError(
            "--synsets lists wnids in alphabetical order, which matches "
            "the wnid-sorted synset_words.txt, not the devkit "
            "ILSVRC2012_ID ordering the ground-truth ids index into; "
            "staging would file every validation image under the wrong "
            "class. Supply the devkit (meta.mat) ordering, or pass "
            "--allow-sorted-synsets if this ordering really is correct.")
    with open(labels_file) as f:
        labels = [int(line) for line in f if line.strip()]
    os.makedirs(out_dir, exist_ok=True)
    staged = 0
    with tarfile.open(val_tar) as tar:
        members = sorted(
            (m for m in tar.getmembers() if m.isfile()),
            key=lambda m: os.path.basename(m.name))
        if len(members) != len(labels):
            raise ValueError(
                "validation tar holds %d images but the ground truth "
                "lists %d labels" % (len(members), len(labels)))
        for member, label in zip(members, labels):
            if not 1 <= label <= len(wnids):
                raise ValueError("class id %d out of range" % label)
            wnid = wnids[label - 1]
            cls_dir = os.path.join(out_dir, wnid)
            os.makedirs(cls_dir, exist_ok=True)
            dst = os.path.join(cls_dir, os.path.basename(member.name))
            if os.path.exists(dst):
                continue
            # write-then-rename: a kill mid-write must not leave a
            # truncated image a resume would skip
            with open(dst + ".tmp", "wb") as w:
                w.write(tar.extractfile(member).read())
            os.rename(dst + ".tmp", dst)
            staged += 1
    log("staged %d validation images into %d classes"
        % (staged, len(set(labels))))
    return staged


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-tar", default=None,
                   help="ILSVRC train archive (tar of per-class tars)")
    p.add_argument("--val-tar", default=None,
                   help="ILSVRC validation archive (flat images)")
    p.add_argument("--val-labels", default=None,
                   help="ground-truth class ids, one per line")
    p.add_argument("--synsets", default=None,
                   help="synset list, line N = class id N in the DEVKIT "
                        "(meta.mat ILSVRC2012_ID) ordering — not the "
                        "wnid-sorted synset_words.txt")
    p.add_argument("--allow-sorted-synsets", action="store_true",
                   help="accept an alphabetically-sorted synset list "
                        "(normally rejected as a mis-ordering symptom)")
    p.add_argument("--out", required=True,
                   help="output tree root for TRAIN classes (point "
                        "root.common.dirs.datasets/ImageNet here)")
    p.add_argument("--val-out", default=None,
                   help="output tree root for VALIDATION classes "
                        "(default: <out>-val). Kept SEPARATE from "
                        "--out on purpose: AutoLabelFileImageLoader "
                        "makes its own held-out split over whatever "
                        "tree it is pointed at, so staging official "
                        "val images into the train tree would leak "
                        "most of them into training")
    args = p.parse_args(argv)
    if not args.train_tar and not args.val_tar:
        p.error("nothing to do: pass --train-tar and/or --val-tar")
    if args.train_tar:
        n = stage_train(args.train_tar, args.out)
        print("train: %d classes staged" % n)
    if args.val_tar:
        if not (args.val_labels and args.synsets):
            p.error("--val-tar needs --val-labels and --synsets")
        stage_val(args.val_tar, args.val_labels, args.synsets,
                  args.val_out or args.out + "-val",
                  allow_sorted_synsets=args.allow_sorted_synsets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
