"""The port's checkpoint format and durability layer
(veles_torch/snapshotter.py) against the JAX package's
(veles/snapshotter.py), on the CPU: a blob written by either package
verifies and loads in the other, under every compression; the same
faults are caught; and the port's twins of the standalone tests of
tests/test_durability.py (the stores, the scan and auto-resume, the
snapshotter's slots, retention and failure budget, the ``checkpoints``
audit)."""

import gzip
import io
import json
import os
import time

import numpy
import pytest
import torch

import veles.snapshotter as JS
from veles.__main__ import checkpoints_main as jax_checkpoints_main
from veles.chaos import corrupt_store_entry, flip_bit, truncate_blob
import veles_torch.model_health as TMH
import veles_torch.snapshotter as TS
from veles_torch.__main__ import checkpoints_main, main as torch_main

from tests.test_torch_resume import torch_mnist
from tests.torch_monitor import port_model_health_isolation  # noqa: F401

COMPRESSIONS = ["", "gz", "bz2", "xz"]


def _tree():
    """A tree with every leaf kind: f32, int32 scalar, int64, uint8,
    nested dicts and JSON values."""
    rng = numpy.random.default_rng(7)
    return {"params": {"u": {"w": rng.standard_normal((6, 5)).astype(
                                  numpy.float32),
                             "b": numpy.arange(5, dtype=numpy.float32)}},
            "state": {"g": {"iteration": numpy.int32(9),
                            "ids": numpy.arange(4, dtype=numpy.int64)}},
            "units": {"d": {"generator": numpy.arange(16, dtype=numpy.uint8)}},
            "decision": {"epoch_number": 3, "best_metric": 0.25,
                         "history": [{"epoch": 0, "train": {"loss": 1.5}}]},
            "meta": {"workflow": "m", "step_index": 12}}


def _assert_same_tree(want, got):
    assert sorted(want) == sorted(got)
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_same_tree(value, got[key])
        elif isinstance(value, (numpy.ndarray, numpy.generic)):
            value = numpy.asarray(value)
            assert got[key].dtype == value.dtype, key
            assert numpy.array_equal(got[key], value), key
        else:
            assert got[key] == value, key


def _name(comp):
    return "m_=0.5.ckpt.npz" + ("." + comp if comp else "")


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_port_blobs_verify_in_the_reference(tmp_path, comp):
    """The port writes (torch tensors among the leaves); the reference's
    parse_checkpoint verifies it and its tree equals the original."""
    tree = _tree()
    tree["params"]["u"]["t"] = torch.arange(3, dtype=torch.float32)
    uri, nbytes = TS.write_checkpoint(TS.FileSnapshotStore(str(tmp_path)),
                                      _name(comp), tree, compression=comp)
    assert nbytes == os.path.getsize(uri)
    with open(uri, "rb") as f:
        flat, manifest = JS.parse_checkpoint(f.read(), uri)
    assert manifest["schema"] == JS.SCHEMA_VERSION == TS.SCHEMA_VERSION
    got = JS._unflatten_tree(flat)
    tree["params"]["u"]["t"] = numpy.arange(3, dtype=numpy.float32)
    _assert_same_tree(tree, got)
    _assert_same_tree(tree, JS.load_snapshot(uri))


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_reference_blobs_verify_in_the_port(tmp_path, comp):
    """The reference writes; the port verifies and loads the same tree,
    and the two manifests of equal trees carry equal array digests."""
    tree = _tree()
    uri, _ = JS.write_checkpoint(JS.FileSnapshotStore(str(tmp_path)),
                                 _name(comp), tree, compression=comp)
    got, manifest = TS.load_snapshot_meta(uri)
    _assert_same_tree(tree, got)
    _, own = TS.parse_checkpoint(TS.dump_checkpoint(tree))
    assert own["arrays"] == manifest["arrays"]


def test_bf16_tensors_are_stored_as_f32():
    """numpy has no bfloat16: a bf16 tensor is written as its f32 value,
    as the reference writes its f32 master copies."""
    flat = TS._flatten_tree({"w": torch.tensor([1.5, -2.25],
                                               dtype=torch.bfloat16)})
    assert flat["w"].dtype == numpy.float32
    assert flat["w"].tolist() == [1.5, -2.25]


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("fault", ["bitflip", "truncate"])
def test_faults_are_caught_on_both_packages_blobs(writer, fault):
    """A flipped bit in an uncompressed payload (four seeded offsets)
    and a truncated gzip (three cuts) of either package's blob raise
    CorruptCheckpointError in the port, as they do in the reference."""
    tree = {"params": {"u": {"w": numpy.zeros((64, 64))}}}
    pkg = TS if writer == "port" else JS
    if fault == "bitflip":
        raw = pkg.dump_checkpoint(tree)
        blobs = [(flip_bit(raw, seed=seed), "x.ckpt.npz")
                 for seed in range(4)]
    else:
        raw = gzip.compress(pkg.dump_checkpoint(tree))
        blobs = [(truncate_blob(raw, frac), "x.ckpt.npz.gz")
                 for frac in (0.1, 0.5, 0.9)]
    for blob, name in blobs:
        with pytest.raises(TS.CorruptCheckpointError):
            TS.parse_checkpoint(blob, name)
        with pytest.raises(JS.CorruptCheckpointError):
            JS.parse_checkpoint(blob, name)


def test_load_snapshot_raises_on_a_truncated_file(tmp_path):
    store = TS.FileSnapshotStore(str(tmp_path))
    uri, _ = TS.write_checkpoint(store, "t_x.ckpt.npz.gz",
                                 {"params": {"u": {"w": numpy.ones(128)}}})
    store.put("t_x.ckpt.npz.gz", truncate_blob(store.get("t_x.ckpt.npz.gz")))
    with pytest.raises(TS.CorruptCheckpointError):
        TS.load_snapshot(uri)


def test_file_store_commit_is_atomic(tmp_path):
    """Write-then-rename: the complete blob or nothing, never a .tmp."""
    store = TS.FileSnapshotStore(str(tmp_path))
    uri = store.put("a_x.ckpt.npz", b"payload")
    assert open(uri, "rb").read() == b"payload"

    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with store.stream("b_x.ckpt.npz"):
            raise Boom()
    assert sorted(os.listdir(str(tmp_path))) == ["a_x.ckpt.npz"]
    open(os.path.join(str(tmp_path), "c_x.ckpt.npz.tmp"), "wb").close()
    assert store.list() == ["a_x.ckpt.npz"]
    with pytest.raises(KeyError):
        store.get("missing.ckpt.npz")
    store.delete("missing.ckpt.npz")


def test_http_targets_name_their_roadmap_item():
    """http(s) targets are no longer refused: they resolve to the one
    breaker-sharing HTTPSnapshotStore of their base URL (nothing is
    fetched here; the stores' traffic is in test_torch_frontend.py)."""
    store, name = TS.store_for("http://127.0.0.1:9/b/x.ckpt.npz")
    assert isinstance(store, TS.HTTPSnapshotStore)
    assert (store.base_url, name) == ("http://127.0.0.1:9/b", "x.ckpt.npz")
    assert TS.store_for_base("http://127.0.0.1:9/b/") is store
    assert TS.store_for_base("https://127.0.0.1:9/c").base_url == \
        "https://127.0.0.1:9/c"
    assert TS.store_for("/tmp/x.ckpt.npz") == (None, "/tmp/x.ckpt.npz")


# -- scan / auto-resume -------------------------------------------------


def _mini(tag):
    return {"params": {"u": {"w": numpy.full(8, float(tag))}},
            "meta": {"tag": tag}}


def _legacy(store, name, tag):
    buf = io.BytesIO()
    numpy.savez(buf, **TS._flatten_tree(_mini(tag)))
    store.put(name, gzip.compress(buf.getvalue()))


def test_scan_orders_and_classifies_as_the_reference(tmp_path):
    """valid (newest first), legacy, corrupt; the reference's scan of the
    same store gives the same names and statuses."""
    store = TS.FileSnapshotStore(str(tmp_path))
    TS.write_checkpoint(store, "wf_=0.5.ckpt.npz.gz", _mini(1))
    TS.write_checkpoint(store, "wf_current-00000001.ckpt.npz.gz", _mini(2))
    _legacy(store, "wf_legacy.ckpt.npz.gz", 0)
    TS.write_checkpoint(store, "wf_current-00000002.ckpt.npz.gz", _mini(3))
    corrupt_store_entry(store, "wf_current-00000002.ckpt.npz.gz",
                        "truncate")
    got = [(i.name, i.status) for i in TS.scan_checkpoints(str(tmp_path))]
    want = [(i.name, i.status) for i in JS.scan_checkpoints(str(tmp_path))]
    assert got == want
    assert got[0] == ("wf_current-00000001.ckpt.npz.gz", "valid")
    assert [s for _, s in got] == ["valid", "valid", "legacy", "corrupt"]


def test_auto_resume_falls_back_past_corruption(tmp_path):
    """The two newest are corrupt (a truncated gzip, a flipped bit): the
    third is resumed and both rejections are counted; nothing valid ->
    None."""
    store = TS.FileSnapshotStore(str(tmp_path))
    for i in (1, 2, 3):
        TS.write_checkpoint(store, "wf_current-%08d.ckpt.npz.gz" % i,
                            _mini(i))
    corrupt_store_entry(store, "wf_current-00000003.ckpt.npz.gz",
                        "truncate")
    corrupt_store_entry(store, "wf_current-00000002.ckpt.npz.gz",
                        "bitflip", seed=7)
    before = TS.COUNTERS.verify_failures
    tree, name, skipped = TS.resolve_auto(str(tmp_path))
    assert name == "wf_current-00000001.ckpt.npz.gz"
    assert tree["meta"]["tag"] == 1 and skipped == 2
    assert TS.COUNTERS.verify_failures - before == 2
    assert JS.resolve_auto(str(tmp_path))[1] == name
    corrupt_store_entry(store, "wf_current-00000001.ckpt.npz.gz",
                        "truncate")
    assert TS.resolve_auto(str(tmp_path)) is None


def test_auto_resume_skips_legacy_and_diverged(tmp_path):
    store = TS.FileSnapshotStore(str(tmp_path))
    _legacy(store, "wf_old.ckpt.npz.gz", 9)
    assert TS.resolve_auto(str(tmp_path)) is None
    TS.write_checkpoint(store, "wf_=0.5.ckpt.npz.gz", _mini(1))
    time.sleep(0.02)
    TS.write_checkpoint(store, "wf_=0.4.ckpt.npz.gz", _mini(2),
                        extra_meta={"model_health": {"verdict": "diverged"}})
    before = TS.COUNTERS.diverged_skips
    _, name, _ = TS.resolve_auto(str(tmp_path))
    assert name == "wf_=0.5.ckpt.npz.gz"
    assert TS.COUNTERS.diverged_skips - before == 1


def test_auto_resume_filters_by_workflow_prefix(tmp_path):
    """Only ``<prefix>_<our stamp>`` names: never another workflow's,
    not even one whose name extends ours."""
    store = TS.FileSnapshotStore(str(tmp_path))
    TS.write_checkpoint(store, "wfA_=0.5.ckpt.npz.gz", _mini(1))
    time.sleep(0.02)
    TS.write_checkpoint(store, "wfB_=0.4.ckpt.npz.gz", _mini(2))
    tree, name, _ = TS.resolve_auto(str(tmp_path), prefixes={"wfA"})
    assert name.startswith("wfA_") and tree["meta"]["tag"] == 1
    assert TS.resolve_auto(str(tmp_path))[1].startswith("wfB_")
    assert TS.resolve_auto(str(tmp_path), prefixes={"wfC"}) is None
    time.sleep(0.02)
    TS.write_checkpoint(store, "wfA_big_current-00000001.ckpt.npz.gz",
                        _mini(3))
    assert TS.resolve_auto(str(tmp_path),
                           prefixes={"wfA"})[1].startswith("wfA_=")
    assert TS.resolve_auto(str(tmp_path), prefixes={"wfA_big"})[1] == \
        "wfA_big_current-00000001.ckpt.npz.gz"


def test_read_side_never_creates_a_missing_store(tmp_path):
    missing = str(tmp_path / "no" / "such" / "dir")
    with pytest.raises(FileNotFoundError):
        TS.resolve_auto(missing)
    with pytest.raises(FileNotFoundError):
        TS.scan_checkpoints(missing)
    assert checkpoints_main([missing]) == 2
    with pytest.raises(FileNotFoundError):
        torch_main([os.path.join(os.path.dirname(__file__), "..",
                                 "veles_torch", "znicz", "models",
                                 "mnist.py"),
                    "-d", "cpu", "--snapshot", "auto:" + missing])
    assert not os.path.exists(missing)
    TS.store_for_base(missing).put("wf_x.ckpt.npz", b"d")
    assert os.path.exists(missing)


# -- the snapshotter ------------------------------------------------------


def test_interval_checkpoints_during_run(tmp_path):
    """A tiny wall-clock interval writes rolling ``current`` checkpoints
    during the run beside the improvement-gated ones, each slot within
    its retention; the newest resumes into a fresh workflow."""
    wf = torch_mnist(3, snapdir=str(tmp_path), interval=1e-6,
                     keep_interval=2)
    wf.run()
    names = TS.FileSnapshotStore(str(tmp_path)).list()
    current = [n for n in names if "_current-" in n]
    best = [n for n in names if "_current-" not in n]
    assert len(current) == 2 and best and len(best) <= 2, names
    tree, name, _ = TS.resolve_auto(str(tmp_path))
    info = TS.scan_checkpoints(str(tmp_path))[0]
    assert info.name == name and info.health_verdict == "healthy"
    fresh = torch_mnist(4)
    fresh.restore_state(tree)
    fresh.run()
    assert fresh.decision.epoch_number == 4
    counts = TS.COUNTERS.metrics()
    assert counts["writes_by_slot"]["current"] >= 2
    assert counts["bytes_total"] > 0 and counts["write_seconds"]
    assert 0.0 <= counts["last_success_age_seconds"] < 60.0


def test_disabled_plane_stamps_unknown(tmp_path):
    """With the model-health plane off (``--model-stats off``) every
    checkpoint is stamped ``unknown``, and auto-resume takes it."""
    TMH.get_model_monitor().enabled = False
    wf = torch_mnist(2, snapdir=str(tmp_path), interval=1e-6)
    wf.step.set_stats_enabled(False)
    wf.run()
    infos = TS.scan_checkpoints(str(tmp_path))
    assert infos and {i.health_verdict for i in infos} == {"unknown"}
    assert TS.resolve_auto(str(tmp_path)) is not None


def _broken_store(snap, fails):
    """Make the next ``fails`` writes of ``snap`` fail as a full disk."""
    stream = snap.store.stream
    left = [fails]

    def broken(name):
        if left[0]:
            left[0] -= 1
            raise OSError("store down")
        return stream(name)

    snap.store.stream = broken


def test_interval_failure_waits_full_interval_to_retry(tmp_path):
    """The gate re-arms before the attempt: a failed interval write is
    retried one interval later, not at the next boundary."""
    wf = torch_mnist(2, snapdir=str(tmp_path))
    snap = wf.snapshotter
    snap.interval = 3600.0
    snap._last_write -= 7200.0
    _broken_store(snap, 100)
    for _ in range(5):
        snap.run()
    assert snap._store_failures == 1


def test_failure_budget_raises_on_the_third_failure(tmp_path):
    """Two failed writes in a row are warned and training goes on; the
    third raises; a success between resets the count."""
    wf = torch_mnist(2, snapdir=str(tmp_path))
    snap = wf.snapshotter
    _broken_store(snap, 2)
    assert snap.export_snapshot() is None
    assert snap.export_snapshot(slot="current") is None
    assert snap.export_snapshot() is not None
    assert snap._store_failures == 0
    _broken_store(snap, 3)
    snap.export_snapshot()
    snap.export_snapshot()
    with pytest.raises(OSError, match="store down"):
        snap.export_snapshot()
    # the preemption path never raises: the process is exiting
    _broken_store(snap, 1)
    assert snap.preempt_snapshot() is None


def test_retention_rebuilt_from_store_after_restart(tmp_path):
    """A fresh snapshotter over the same store adopts its predecessor's
    snapshots, keeps pruning them, and continues the rolling
    sequence."""
    wf = torch_mnist(2, snapdir=str(tmp_path), name="RetA")
    snap = wf.snapshotter
    for i in range(3):
        wf.decision.best_metric = 0.5 - 0.1 * i
        snap.export_snapshot()
        snap.export_snapshot(slot="current")
    store = TS.FileSnapshotStore(str(tmp_path))
    assert len([n for n in store.list() if "_current-" in n]) == 2
    wf2 = torch_mnist(2, snapdir=str(tmp_path), name="RetA")
    snap2 = wf2.snapshotter
    assert snap2._written
    for i in range(3):
        wf2.decision.best_metric = 0.1 - 0.01 * i
        snap2.export_snapshot()
        snap2.export_snapshot(slot="current")
    names = store.list()
    assert len([n for n in names if "_current-" not in n]) <= snap2.keep
    current = [n for n in names if "_current-" in n]
    assert current == ["RetA_current-00000005.ckpt.npz",
                       "RetA_current-00000006.ckpt.npz"]


def test_initial_name_before_any_metric(tmp_path):
    wf = torch_mnist(1, snapdir=str(tmp_path), name="Init")
    assert os.path.basename(wf.snapshotter.export_snapshot()) == \
        "Init_initial.ckpt.npz"
    with pytest.raises(ValueError, match="compression"):
        wf.link_snapshotter(directory=str(tmp_path), compression="zip")


def test_export_inference_on_each_best_snapshot(tmp_path):
    """``export_inference`` re-exports the archive at each improved
    snapshot: the archive's weights are the checkpoint's."""
    wf = torch_mnist(2)
    snap = wf.link_snapshotter(directory=str(tmp_path / "s"),
                               export_inference=str(tmp_path / "a"),
                               compression="")
    wf.run()
    tree = TS.load_snapshot(snap.destination)
    w = numpy.load(str(tmp_path / "a" / "All2AllTanh_weights.npy"))
    assert numpy.array_equal(w, tree["params"]["All2AllTanh"]["weights"])


# -- the checkpoints audit -------------------------------------------------


def _audit_rows(main, store, capsys):
    rc = main(["--json", store])
    rows = json.loads(capsys.readouterr().out)
    for r in rows:
        r.pop("age_s")
        r["error"] = bool(r["error"])
    return rc, rows


def test_checkpoints_audit_equals_the_reference_cli(tmp_path, capsys):
    """On one store of valid, legacy and corrupt blobs written by both
    packages: the same --json rows as the reference CLI's (ages and the
    errors' wording aside) and the same exit codes; the table names every
    status."""
    store = TS.FileSnapshotStore(str(tmp_path))
    TS.write_checkpoint(store, "wf_=0.2.ckpt.npz.gz", _mini(1))
    JS.write_checkpoint(JS.FileSnapshotStore(str(tmp_path)),
                        "wf_=0.3.ckpt.npz.gz", _mini(2))
    _legacy(store, "wf_old.ckpt.npz.gz", 0)
    assert checkpoints_main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "valid" in out and "legacy" in out
    TS.write_checkpoint(store, "wf_current-00000009.ckpt.npz.gz", _mini(3))
    corrupt_store_entry(store, "wf_current-00000009.ckpt.npz.gz",
                        "truncate")
    got = _audit_rows(checkpoints_main, str(tmp_path), capsys)
    want = _audit_rows(jax_checkpoints_main, str(tmp_path), capsys)
    assert got == want
    rc, rows = got
    assert rc == 1
    assert {r["status"] for r in rows} == {"valid", "legacy", "corrupt"}
    assert torch_main(["checkpoints", str(tmp_path)]) == 1
