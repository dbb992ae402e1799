"""The port's kernel builder (veles_torch/kernels.py) on the CPU: a
library is named by its source, every shared header and the flags, so an
edit to any of them gives a new library and a stale one is never loaded."""

import os

from veles_torch import kernels


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_library_path_follows_the_source_and_every_header(tmp_path,
                                                          monkeypatch):
    src = str(tmp_path)
    _write(os.path.join(src, "a.cu"), '#include "h.cuh"\n// a\n')
    _write(os.path.join(src, "b.cu"), "// b\n")
    _write(os.path.join(src, "h.cuh"), "// h\n")
    monkeypatch.setattr(kernels, "SOURCE_DIR", src)
    assert kernels.sources() == ["a", "b"]
    first = {name: kernels.library_path(name) for name in ("a", "b")}
    assert first == {name: kernels.library_path(name)
                     for name in ("a", "b")}
    assert os.path.basename(first["a"]).startswith("liba-")
    _write(os.path.join(src, "h.cuh"), "// h, changed\n")
    second = {name: kernels.library_path(name) for name in ("a", "b")}
    # a source may include any header, so every library follows each one
    assert all(second[n] != first[n] for n in first)
    _write(os.path.join(src, "g.cuh"), "// a new header\n")
    third = kernels.library_path("a")
    assert third not in (first["a"], second["a"])
    _write(os.path.join(src, "a.cu"), '#include "h.cuh"\n// a, changed\n')
    assert kernels.library_path("a") not in (first["a"], second["a"], third)
    assert kernels.library_path("b") == kernels.library_path("b")


def test_the_port_sources_share_one_hopper_header():
    """Every wgmma + TMA source includes csrc/sm90.cuh, and it is hashed
    into their libraries' names."""
    sm90 = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_dq_sm90")
    names = kernels.sources()
    assert set(sm90) <= set(names)
    for name in sm90:
        with open(os.path.join(kernels.SOURCE_DIR, name + ".cu")) as f:
            assert '#include "sm90.cuh"' in f.read()
    assert os.path.exists(os.path.join(kernels.SOURCE_DIR, "sm90.cuh"))
