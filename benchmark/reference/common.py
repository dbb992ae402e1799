"""What every plain reference shares: its precision and its momentum steps.

The references are plain PyTorch in float32 with TF32 off, their
gradients taken by autograd. They import nothing of the program under
test. :class:`Precision` rounds the operands of every product (matmul and
convolution, forward and backward) to a lower precision when asked: the
control that the comparison has to reject computes the same reference in
fp8 (e4m3, scaled per tensor to its largest magnitude, as fp8 training
scales). Everything else stays float32.
"""

import torch

#: the precisions a reference can round its products' operands to
DTYPES = {"f32": None, "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}

#: the largest finite e4m3 value
E4M3_MAX = 448.0


def round_to(x, dtype):
    """``x`` rounded to ``dtype`` and back to its own dtype; fp8 scaled so
    that the tensor's largest magnitude lands on e4m3's largest value."""
    if dtype == torch.float8_e4m3fn:
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        return (x * scale).to(dtype).to(x.dtype) / scale
    return x.to(dtype).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Rounds in the forward pass; passes the gradient through."""

    @staticmethod
    def forward(ctx, x, dtype):
        return round_to(x, dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Product(torch.autograd.Function):
    """The identity in the forward pass; rounds the gradient that flows
    back into the product, which the backward products take."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return round_to(grad, ctx.dtype), None


class Precision:
    """The operands of every product in ``name`` ("f32", "bf16", "fp8");
    sums, nonlinearities and the update stay float32."""

    def __init__(self, name="f32"):
        self.name = name
        self.dtype = DTYPES[name]

    def operand(self, x):
        return x if self.dtype is None else _Operand.apply(x, self.dtype)

    def product(self, y):
        return y if self.dtype is None else _Product.apply(y, self.dtype)

    def matmul(self, a, b):
        return self.product(torch.matmul(self.operand(a), self.operand(b)))

    def conv2d(self, x, w, stride, padding):
        return self.product(torch.nn.functional.conv2d(
            self.operand(x), self.operand(w), stride=stride,
            padding=padding))


def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def train_readings(params0, batches, loss_fn, hyper, vel0=None):
    """Momentum steps of ``loss_fn(params, batch)`` over ``batches`` from
    ``params0`` ({name: float32 tensor}) and the velocities ``vel0``
    (zeros when None), as the program's solver steps: ``reg = grad +
    l2·w``; ``vel = moment·vel − lr·reg``; ``w += vel``. ``hyper`` is
    {name: (lr, moment, l2)}. -> {"losses": [one a step], "grad_norms":
    {name: ‖reg‖ of the first step}, "update_norms": {name: ‖w − w0‖
    after the last step}}."""
    no_tf32()
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in params0.items()}
    vel = {n: torch.zeros_like(p) if vel0 is None else vel0[n].clone()
           for n, p in params.items()}
    losses, grad_norms = [], {}
    for k, batch in enumerate(batches):
        for p in params.values():
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        with torch.no_grad():
            for n, p in params.items():
                lr, moment, l2 = hyper[n]
                reg = p.grad + l2 * p if l2 else p.grad
                if k == 0:
                    grad_norms[n] = float(torch.linalg.vector_norm(reg))
                vel[n] = moment * vel[n] - lr * reg
                p += vel[n]
        losses.append(float(loss.detach()))
        del loss
    with torch.no_grad():
        update_norms = {n: float(torch.linalg.vector_norm(
            params[n] - params0[n])) for n in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "update_norms": update_norms}
