"""The port's per-step accounting (veles_torch/perf.py) against the JAX
package's (veles/perf.py) on the CPU.

The port counts one real dispatch under a ``TorchDispatchMode`` where the
reference walks a jaxpr, so the two are held where they must agree: the
matmul and convolution FLOPs exactly (the shapes of tests/test_perf.py,
an MNIST epoch and a small LM's epoch against the reference's epoch
program), and the totals, whose elementwise estimates split work
differently (a reshape is one flop per element in a jaxpr and free as an
aten view), within ``TOTAL_RTOL``. The flash kernels' reported work
equals their plain versions' counted products with ``causal=False`` (the
kernels report the causal half) and ``chip_smoke.FLASH_WORK``. The
ledger caches per key, re-counts a dead owner's reused id and degrades a
counter failure to a zero cost; the peak table, its env overrides and
the precision classes (the port's int8/fp8 serving products are
dequantized f32 products); a counted MNIST epoch is bit for bit an
uncounted one; a ``-d cpu`` run exports the ``veles_step_*`` families,
tokens/s for the LM.
"""

import gc
import os
import sys

import jax
import numpy
import pytest
import torch

from veles import perf as JP
from veles_torch import perf as TP
from veles_torch import telemetry as TT
from veles_torch.convert import params_to_numpy
from veles_torch.loader.base import CLASS_TRAIN
from veles_torch.znicz.ops import flash_attention as FA

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from test_torch_lm import jax_lm, lm_config, torch_lm  # noqa: E402
from test_torch_mnist import jax_workflow, torch_workflow  # noqa: E402

#: the port's total against the reference's for the same epoch: observed
#: 0.940 (MNIST, mb 20) and 0.989 (the LM below) of the reference's
TOTAL_RTOL = 0.1
MNIST_SIZES = dict(minibatch_size=20, n_train=100, n_valid=40)
LM_SMALL = dict(loader={"minibatch_size": 8, "n_train": 32, "n_valid": 16,
                        "seq_len": 64, "vocab": 16},
                model={"dim": 64, "heads": 2, "layers": 2,
                       "ffn_hidden": 128, "attn_impl": None},
                decision={"max_epochs": 1})


def count(fn, *args):
    with TP.CostCounter() as counter:
        out = fn(*args)
    return out, counter.cost()


# -- the counter's arithmetic ----------------------------------------------


def _conv(x, k):
    return jax.lax.conv_general_dilated(x, k, (1, 1), "VALID")


@pytest.mark.parametrize("case", ["matmul", "conv"])
def test_matmul_and_conv_flops_exact(case):
    """tests/test_perf.py's shapes: the counter's FLOPs equal the
    reference's walk of the same product, 2·M·N·K and 2·|out|·taps."""
    import jax.numpy as jnp
    if case == "matmul":
        x = numpy.ones((8, 8), numpy.float32)
        want = JP.program_cost(jax.jit(lambda a: a @ a), (jnp.asarray(x),))
        _, got = count(lambda a: a @ a, torch.from_numpy(x))
        assert got.flops == 2 * 8 * 8 * 8
        assert got.io_bytes == x.nbytes
    else:
        x = numpy.ones((1, 3, 8, 8), numpy.float32)
        k = numpy.ones((4, 3, 3, 3), numpy.float32)
        want = JP.program_cost(_conv, (jnp.asarray(x), jnp.asarray(k)))
        _, got = count(torch.nn.functional.conv2d, torch.from_numpy(x),
                       torch.from_numpy(k))
        assert got.flops == 2 * (1 * 4 * 6 * 6) * (3 * 3 * 3)
    assert got.flops == want.flops == got.dot_flops
    assert got.bytes > 0


def test_other_products_and_elementwise_rules():
    """addmm/bmm count 2·|out|·K; the convolution's backward counts its
    input and weight gradients as the forward's footprint; other ops one
    flop per output element (an in-place op's output once, a _foreach_
    op's written list); views, empty and host copies nothing."""
    a, b = torch.ones(3, 10), torch.ones(10, 5)
    _, c = count(torch.addmm, torch.ones(5), a, b)
    assert c.dot_flops == 2 * 15 * 10 and c.flops == 2 * 15 * 10
    _, c = count(torch.bmm, torch.ones(2, 3, 4), torch.ones(2, 4, 6))
    assert c.flops == 2 * 2 * 3 * 6 * 4
    x, w = torch.ones(2, 3, 8, 8), torch.ones(4, 3, 3, 3)
    _, c = count(lambda: torch.ops.aten.convolution_backward(
        torch.ones(2, 4, 6, 6), x, w, None, (1, 1), (0, 0), (1, 1), False,
        (0, 0), 1, (True, True, False)))
    assert c.dot_flops == 2 * x.numel() * 4 * 9 + 2 * w.numel() * 2 * 36
    y = torch.ones(4, 5)

    def elementwise():
        y.add_(1)                       # 20 written once
        torch._foreach_mul_([y, y], 2.0)  # the same tensor twice: 20
        y.view(20).t()                  # views: nothing
        torch.empty(100)                # allocation: nothing
        return y.sum()                  # 1
    _, c = count(elementwise)
    assert c.flops == 20 + 20 + 1 and c.dot_flops == 0
    assert c.bytes == 4 * (20 + 20 + 1)
    assert c.io_bytes == y.nbytes


@pytest.mark.parametrize("form", sorted(FA.WORK))
def test_flash_kernels_report_their_plain_versions_products(form):
    """Each kernel's reported flops (``kernel_cost``) equal its plain
    version's counted products with ``causal=False``, and the causal half
    equals FLASH_WORK's count; the report reaches the active counter with
    the bf16 class and the kernel's name."""
    shape = (2, 3, 32, 16)
    g = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn(shape, generator=g) for _ in range(4))
    out, lse = FA.flash_attention_fwd_plain(q, k, v, causal=False)
    plain = {"fwd": lambda: FA.flash_attention_fwd_plain(q, k, v, False),
             "bwd": lambda: FA.flash_attention_bwd_plain(
                 q, k, v, out, lse, dout, False),
             "dq": lambda: FA.flash_attention_dq_plain(
                 q, k, v, out, lse, dout, False),
             "dkv": lambda: FA.flash_attention_dkv_plain(
                 q, k, v, out, lse, dout, False)}[form]
    _, counted = count(plain)
    flops, _ = FA.kernel_cost(form, shape, False, torch.float32)
    assert flops == counted.dot_flops
    b, h, s, dh = shape
    products = chip_smoke.FLASH_WORK[form][0]
    half, nbytes = FA.kernel_cost(form, shape, True, torch.bfloat16)
    assert half == products * b * h * s * s * dh / 2 == flops / 2
    assert nbytes == (FA.WORK[form][1] * b * h * s * dh * 2
                      + FA.WORK[form][2] * b * h * s * 4)
    name = "flash_bwd_fused" if form == "bwd" else \
        "flash_fwd" if form == "fwd" else "flash_bwd_" + form
    _, c = count(FA._report, name, form, shape, True, torch.bfloat16)
    assert c.kernel_flops == {name: half} and c.precision == "bf16"
    assert c.flops == c.dot_flops == half and c.bytes == nbytes


def test_bias_grad_reports_its_operations():
    """The bias gradient's report: OPS_PER_ELEMENT f32 operations an
    element (chip_smoke's bound uses the same table), 4·K bytes
    written, no product class."""
    from veles_torch.znicz.ops import bias_grad as BG
    assert BG.OPS_PER_ELEMENT["tanh"] == 5
    with TP.CostCounter() as c:
        TP.add_kernel_cost("bias_grad[masked]",
                           BG.OPS_PER_ELEMENT["tanh"] * 100 * 100, 400)
    cost = c.cost()
    assert cost.kernel_flops == {"bias_grad[masked]": 5e4}
    assert cost.dot_flops == 0 and cost.bytes == 400
    # no counter on the thread: the report goes nowhere
    TP.add_kernel_cost("bias_grad[identity]", 1.0, 4)
    assert TP.active_counter() is None


# -- against the reference's epoch programs ---------------------------------


@pytest.fixture
def reference_epoch_costs(monkeypatch):
    """The reference's epoch programs' (flops, dot flops) as its ledger
    sees them: each program walked before it runs (donation invalidates
    its arguments after)."""
    seen = []
    original = JP.ledger.cost

    def spy(key, fn, args):
        closed = jax.make_jaxpr(fn)(*args)
        prec = {}
        flops, _ = JP._jaxpr_cost(closed.jaxpr, prec)
        seen.append((key, flops, sum(prec.values())))
        return original(key, fn, args)

    monkeypatch.setattr(JP.ledger, "cost", spy)
    return seen


def port_epoch(step):
    """(flops, dot flops) of the port's epoch: each class's minibatches at
    their signature's cost (a due train step costs its stats more)."""
    flops = dots = 0.0
    for (cls, n, _), cost in step.costs.items():
        if cls != CLASS_TRAIN:
            flops += n * cost.flops
            dots += n * cost.dot_flops
    for t in range(step.train_steps):
        cost = next(c for (cls, _, due), c in step.costs.items()
                    if cls == CLASS_TRAIN and due == step.stats_due(t))
        flops += cost.flops
        dots += cost.dot_flops
    return flops, dots


def _against_reference(seen, step):
    (key, want, want_dots), = seen
    assert key[0] == "epoch" and key[2] == 1        # one epoch a program
    flops, dots = port_epoch(step)
    assert dots == want_dots
    assert abs(flops / want - 1) <= TOTAL_RTOL, (flops, want)


def test_mnist_epoch_against_the_reference_program(reference_epoch_costs):
    jw = jax_workflow(MNIST_SIZES, 1)
    jw.xla_step.epochs_per_dispatch = 1
    jw.run()
    tw = torch_workflow(MNIST_SIZES, 1)
    tw.run()
    _against_reference(reference_epoch_costs, tw.step)


def test_lm_epoch_against_the_reference_program(reference_epoch_costs):
    """2 layers, dim 64, S 64, dense attention on both sides."""
    with lm_config(**LM_SMALL):
        jw = jax_lm()
        jw.xla_step.epochs_per_dispatch = 1
        jw.run()
        tw = torch_lm()
        tw.run()
    assert not any(tw.step.costs[sig].kernel_flops for sig in tw.step.costs)
    _against_reference(reference_epoch_costs, tw.step)


# -- the ledger -------------------------------------------------------------


class _Owner:
    pass


def test_ledger_caches_per_key_and_recounts_a_reused_id():
    ledger = TP.PerfLedger()
    counted = []
    owner = _Owner()

    def fn(x):
        counted.append(TP.active_counter() is not None)
        return x * 2

    x = torch.ones(4)
    out1, c1 = ledger.cost(("k", id(owner)), fn, (x,), owner=owner)
    out2, c2 = ledger.cost(("k", id(owner)), fn, (x,), owner=owner)
    assert c1 is c2 and counted == [True, False]    # counted once
    assert torch.equal(out1, out2) and c1.flops == 4
    assert ledger.sizes() == {"programs": 1, "est_bytes": x.nbytes}
    # another owner under the same key (an id a dead owner left) counts
    # again instead of inheriting the old cost
    other = _Owner()
    _, c3 = ledger.cost(("k", id(owner)), fn, (x,), owner=other)
    assert c3 is not c1 and counted[-1]
    del other
    gc.collect()
    assert ledger.sizes()["programs"] == 0      # dead owners not counted


def test_ledger_degrades_a_counter_failure_but_not_the_dispatch(
        monkeypatch):
    ledger = TP.PerfLedger()

    def broken(self, func, args, out):
        raise RuntimeError("accounting bug")

    monkeypatch.setattr(TP.CostCounter, "_account", broken)
    out, cost = ledger.cost("k", lambda x: x + 1, (torch.zeros(3),))
    assert torch.equal(out, torch.ones(3))
    assert cost.flops == 0.0 and cost.kernel_flops == {}
    # recording a zero cost and no samples is a no-op, not a crash
    ledger.record_dispatch("train", cost, 0.01)
    with pytest.raises(ZeroDivisionError):
        ledger.cost("k2", lambda: 1 / 0, ())     # the dispatch's own error


# -- peaks and precision classes ----------------------------------------------


def test_device_peak_env_overrides_and_table(monkeypatch):
    for var in ("VELES_PEAK_FLOPS", "VELES_PEAK_FLOPS_INT8",
                "VELES_PEAK_FLOPS_FP8"):
        monkeypatch.delenv(var, raising=False)
    assert TP.device_peak_flops() is None            # no card here
    assert TP.device_peak_flops("bf16", "cpu") is None
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("VELES_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("VELES_PEAK_FLOPS_INT8", "2e12")
    monkeypatch.setenv("VELES_PEAK_FLOPS_FP8", "3e12")
    assert TP.device_peak_flops("bf16") == 1e12
    assert TP.device_peak_flops("int8") == 2e12
    assert TP.device_peak_flops("fp8") == 3e12
    # the f32 classes have no override of their own: the default's
    assert TP.device_peak_flops("tf32") == TP.device_peak_flops("f32") \
        == 1e12
    monkeypatch.setenv("VELES_PEAK_FLOPS", "garbage")
    assert TP.device_peak_flops() is None
    monkeypatch.delenv("VELES_PEAK_FLOPS_INT8")
    assert TP.device_peak_flops("int8") is None
    # the card's table, by its name: NVIDIA's H100 SXM datasheet
    monkeypatch.delenv("VELES_PEAK_FLOPS")
    monkeypatch.delenv("VELES_PEAK_FLOPS_FP8")
    monkeypatch.setattr(TP, "_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert [TP.device_peak_flops(p) for p in
            ("bf16", "fp8", "int8", "tf32", "f32")] == \
        [989.4e12, 1978.9e12, 1978.9e12, 494.7e12, 66.9e12]


@pytest.mark.parametrize("a,b,tf32,want", [
    (torch.float32, torch.float32, False, "f32"),
    (torch.float32, torch.float32, True, "tf32"),
    (torch.bfloat16, torch.bfloat16, False, "bf16"),
    (torch.float16, torch.bfloat16, False, "bf16"),
    (torch.int8, torch.int8, False, "int8"),
    (torch.float8_e4m3fn, torch.float8_e4m3fn, False, "fp8"),
    (torch.int8, torch.bfloat16, False, "bf16"),
    (torch.uint8, torch.float32, True, "tf32")])
def test_dot_precision_classes(a, b, tf32, want):
    assert TP.dot_class(a, b, tf32) == want


def test_program_precision_is_the_dominant_product_class():
    a8 = torch.ones(32, 32, dtype=torch.int8)
    _, c = count(torch._int_mm, a8, a8)
    assert c.precision == "int8"
    f8 = torch.ones(32, 32).to(torch.float8_e4m3fn)
    _, c = count(lambda: torch._scaled_mm(
        f8, f8.t(), torch.tensor(1.0), torch.tensor(1.0),
        out_dtype=torch.float32))
    assert c.precision == "fp8"
    _, c = count(lambda: torch.ones(64, 64) @ torch.ones(64, 64)
                 + (torch.ones(8, 8, dtype=torch.bfloat16)
                    @ torch.ones(8, 8, dtype=torch.bfloat16)).float().sum())
    assert c.precision == "f32"


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_serving_products_are_f32_class(mode, tmp_path):
    """The port's int8/fp8 serving weights are dequantized at dispatch and
    multiplied in f32: the forward is scored against the f32 peak, never
    the 8-bit one."""
    from veles_torch.serving import ArchiveModel, InferenceEngine
    wf = torch_workflow(MNIST_SIZES, 1)
    wf.export_inference(str(tmp_path))
    eng = InferenceEngine(ArchiveModel.from_dir(str(tmp_path), device="cpu"),
                          max_batch=16, quantize=mode, device="cpu")
    x = numpy.asarray(wf.loader.original_data[:16], numpy.float32)
    _, c = count(eng.predict, x)
    assert c.precision == "f32"
    assert c.dot_flops == 2 * 16 * (784 * 100 + 100 * 10)


# -- the step ---------------------------------------------------------------


def test_counted_epoch_is_bit_for_bit_an_uncounted_one(monkeypatch):
    counted = torch_workflow(MNIST_SIZES, 2)
    counted.run()
    assert counted.step.costs and all(
        c.flops > 0 for c in counted.step.costs.values())
    monkeypatch.setattr(TP.ledger, "cost", lambda key, fn, args, owner=None:
                        (fn(*args), TP.StepCost()))
    plain = torch_workflow(MNIST_SIZES, 2)
    plain.run()
    want = params_to_numpy(plain.export_tree())
    got = params_to_numpy(counted.export_tree())
    assert sorted(want) == sorted(got)
    for unit in want:
        for key in want[unit]:
            assert numpy.array_equal(want[unit][key], got[unit][key]), \
                (unit, key)
    assert counted.decision.history == plain.decision.history


def _family(text, name):
    return {line.split(" ")[0]: float(line.split(" ")[1])
            for line in text.splitlines()
            if line.startswith(name + "{")}


def test_step_families_on_a_cpu_run(monkeypatch):
    """After a ``-d cpu`` MNIST run: flops and bytes by kind equal the
    step's signature costs times its minibatches, FLOP/s, samples/s and
    (VELES_PEAK_FLOPS set) an MFU ratio; an LM run adds tokens/s, S per
    sample."""
    monkeypatch.setenv("VELES_PEAK_FLOPS", "1e12")
    with TT.scoped():
        wf = torch_workflow(MNIST_SIZES, 2)
        wf.run()
        text = TT.get_registry().render_prometheus()
    flops = _family(text, "veles_step_flops_total")
    want, _ = port_epoch(wf.step)
    valid = sum(n * c.flops for (cls, n, _), c in wf.step.costs.items()
                if cls != CLASS_TRAIN)
    assert flops['veles_step_flops_total{kind="valid"}'] == 2 * valid
    assert flops['veles_step_flops_total{kind="train"}'] == pytest.approx(
        want - valid, rel=1e-12)
    for name in ("veles_step_bytes_total", "veles_step_flops_per_second",
                 "veles_step_mfu_ratio", "veles_step_samples_per_second"):
        values = _family(text, name)
        assert sorted(values) == ['%s{kind="train"}' % name,
                                  '%s{kind="valid"}' % name], name
        assert all(v > 0 for v in values.values())
    mfu = _family(text, "veles_step_mfu_ratio")
    fps = _family(text, "veles_step_flops_per_second")
    assert mfu['veles_step_mfu_ratio{kind="train"}'] == pytest.approx(
        fps['veles_step_flops_per_second{kind="train"}'] / 1e12)
    assert "veles_step_tokens_per_second" not in text
    with TT.scoped(), lm_config(**LM_SMALL):
        torch_lm().run()
        text = TT.get_registry().render_prometheus()
    tps = _family(text, "veles_step_tokens_per_second")
    sps = _family(text, "veles_step_samples_per_second")
    assert tps['veles_step_tokens_per_second{kind="train"}'] == \
        pytest.approx(64 * sps['veles_step_samples_per_second{kind="train"}'])
