"""Shared spatial-op math of the port, over torch tensors.

Counterpart of ``veles/znicz_tpu/ops/conv_math.py`` (``out_size``,
``normalize_padding``, ``pad_nhwc``, ``im2col``, ``col2im`` and
``sliding_channel_sum``). Layout is NHWC throughout, as in the
reference. The convolutions themselves go to cuDNN (``ops/conv.py``);
``im2col``/``col2im`` are the plain im2col + GEMM structure the tests
hold them against, and the window helpers ``window_taps``/``scatter_taps``
are what pooling computes with: one strided view per window tap, so no
(B, oy, ox, ky·kx, C) patch tensor is made on the main path, and the
backward adds each tap's share in tap order, without atomics.

Left out: the reference's space-to-depth helpers (``s2d_block``,
``s2d_pack_input``, ``s2d_unpack_wgrad``), a TPU MXU layout trick for
the weight-gradient convolution that changes no number.
"""

import torch
import torch.nn.functional as F


def out_size(size, k, stride, pad_lo, pad_hi):
    return (size + pad_lo + pad_hi - k) // stride + 1


def normalize_padding(padding):
    """-> (top, bottom, left, right). Accepts int, (py, px) or the
    4-tuple."""
    if isinstance(padding, int):
        return (padding,) * 4
    if len(padding) == 2:
        py, px = padding
        return (int(py), int(py), int(px), int(px))
    if len(padding) == 4:
        return tuple(int(p) for p in padding)
    raise ValueError("bad padding %r" % (padding,))


def pad_nhwc(x, pads, value=0.0):
    """Pad the H and W axes of a (B, H, W, C) tensor by ``pads`` =
    (top, bottom, left, right)."""
    top, bottom, left, right = pads
    if not any(pads):
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def crop_nhwc(x, top, left, h, w):
    """The (h, w) window at (top, left) of the H and W axes of a (B, H, W,
    C) tensor, zero where it reaches past the bottom or right edge."""
    x = pad_nhwc(x, (0, max(0, top + h - x.shape[1]),
                     0, max(0, left + w - x.shape[2])))
    return x[:, top:top + h, left:left + w, :]


def window_taps(x, ky, kx, stride, oy, ox):
    """-> [(p·kx + q, view)] over the ky·kx taps of a (B, H, W, C) tensor
    already padded: tap (p, q) is the (B, oy, ox, C) strided view of the
    element at offset (p, q) of every window, in window order."""
    sy, sx = stride
    return [(p * kx + q, x[:, p:p + sy * (oy - 1) + 1:sy,
                           q:q + sx * (ox - 1) + 1:sx, :])
            for p in range(ky) for q in range(kx)]


def scatter_taps(pieces, shape, ky, kx, stride, dtype=torch.float32):
    """Adjoint of :func:`window_taps`: overlap-add each tap's (B, oy, ox,
    C) piece (``pieces(t)`` for tap t) into a zero (B, H, W, C) tensor of
    ``dtype``, tap after tap in window order — no atomics, so the sum's
    order is fixed."""
    b, h, w, c = shape
    first = pieces(0)
    acc = torch.zeros((b, h, w, c), dtype=dtype, device=first.device)
    oy, ox = first.shape[1], first.shape[2]
    for t, view in window_taps(acc, ky, kx, stride, oy, ox):
        view.add_(first if t == 0 else pieces(t))
    return acc


def im2col(x, ky, kx, stride, pads):
    """(B,H,W,C) -> (B, oy, ox, ky*kx*C) patch tensor."""
    x = pad_nhwc(x, pads)
    b, h, w, c = x.shape
    oy = (h - ky) // stride[0] + 1
    ox = (w - kx) // stride[1] + 1
    taps = [v for _, v in window_taps(x, ky, kx, stride, oy, ox)]
    return torch.stack(taps, dim=3).reshape(b, oy, ox, ky * kx * c)


def col2im(cols, input_shape, ky, kx, stride, pads):
    """Adjoint of im2col: overlap-add patches back to (B,H,W,C)."""
    b, h, w, c = input_shape
    top, bottom, left, right = pads
    oy, ox = cols.shape[1], cols.shape[2]
    cols = cols.reshape(b, oy, ox, ky * kx, c)
    acc = scatter_taps(lambda t: cols[:, :, :, t, :],
                       (b, h + top + bottom, w + left + right, c),
                       ky, kx, stride, cols.dtype)
    return crop_nhwc(acc, top, left, h, w)


def sliding_channel_sum(x, window, reverse=False):
    """Sum over a centered window along the channel (last) axis, same
    length out (AlexNet LRN's cross-map window). ``reverse`` flips the
    window asymmetry — the adjoint for even windows. Small windows sum
    ``window`` shifted slices, large ones take a cumsum difference, as
    the reference does."""
    half_lo = (window - 1) // 2
    half_hi = window - 1 - half_lo
    if reverse:
        half_lo, half_hi = half_hi, half_lo
    padded = F.pad(x, (half_lo, half_hi))
    n = x.shape[-1]
    if window <= 16:
        out = padded[..., 0:n]
        for i in range(1, window):
            out = out + padded[..., i:i + n]
        return out
    csum = torch.cumsum(padded, dim=-1)
    csum = F.pad(csum, (1, 0))
    return csum[..., window:window + n] - csum[..., :n]
