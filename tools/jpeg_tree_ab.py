"""Phase ``image_jpeg`` of ``chip_smoke.py`` on one card with its tree
coded two ways, in turns (Huffman, mixed, mixed, Huffman): every copy the
Huffman fixture ``tree_NN.jpg``, or the phase's own mixed tree (the
Huffman file and its arithmetic-coded twin ``arith_tree_NN.jpg`` in turn,
the same pixels). Each run prints the phase's JSON row (decode ms, warm
images/s, stream waits, scans by routine and coding, launches) and holds
the run to the phase's checks.

    python3 tools/jpeg_tree_ab.py  # one H100
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402
from veles_torch import kernels  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    os.makedirs(C.OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    kernels.build()
    print("build", time.perf_counter() - t0)
    huffman, mixed = ("huffman",), C.JPEG_TREE_CODINGS
    for codings in (huffman, mixed, mixed, huffman):
        C.check_image_jpeg(torch, codings)


if __name__ == "__main__":
    main()
