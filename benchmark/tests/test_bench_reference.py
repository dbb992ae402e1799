"""Each plain reference against the program's ``-d cpu`` path at a tiny
size: on the CPU the program computes in float32, so the two agree to
round-off (AlexNet's softplus derivative, taken from the output, loses a
few digits where the output is tiny)."""

import pytest

TOLERANCE = {"lm": 1e-5, "alexnet": 1e-3}


@pytest.mark.parametrize("family", ["lm", "alexnet"])
def test_reference_follows_the_program_on_the_cpu(family, request):
    import harness
    cell = request.getfixturevalue("tiny_" + family)
    result = harness.run_cell(cell, 20260 + len(family), 0.2, 0,
                              device="cpu")
    for name, v in result["check"].items():
        assert v["value"] < TOLERANCE[family], (name, v)
    assert result["correct"]


def test_reference_is_plain():
    """The references import neither JAX, nor the JAX package, nor
    anything of the program."""
    import ast
    import glob
    import os
    from conftest import BENCH
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top in ("torch", "numpy", "reference", "math"), (
                    path, name)


def test_control_precision_rounds_products():
    """The control's fp8 operands differ from float32 by e4m3's step,
    bf16's by bf16's."""
    import torch
    from reference.common import Precision
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    b = torch.randn(64, 64, generator=torch.Generator().manual_seed(2))
    exact = a @ b
    scale = exact.abs().max()
    err16 = (Precision("bf16").matmul(a, b) - exact).abs().max() / scale
    err8 = (Precision("fp8").matmul(a, b) - exact).abs().max() / scale
    assert (Precision("f32").matmul(a, b) == exact).all()
    assert 1e-4 < err16 < 1e-2 < err8 < 0.2
