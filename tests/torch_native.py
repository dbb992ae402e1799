"""The native image-decode routines of ``veles_torch/csrc/image_decode.cu``
(host code only: ``kernels.py`` builds it with the toolkit on the card)
built with the host's g++ for the CPU tests, and bound as
``jpeg.native_library`` binds them."""

import os
import shutil
import subprocess

import pytest


def build_image_decode(out_dir):
    """``g++ -x c++ -O2 -shared -fPIC`` of the source into ``out_dir`` ->
    the bound library; skips where the host has no g++."""
    from veles_torch import kernels
    from veles_torch.loader import jpeg
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native routine on the host")
    out = os.path.join(str(out_dir), "libimage_decode.so")
    subprocess.run(["g++", "-x", "c++", "-O2", "-shared", "-fPIC", "-o", out,
                    os.path.join(kernels.SOURCE_DIR, "image_decode.cu")],
                   check=True)
    return kernels.open_library(out, jpeg.SIGNATURES)
