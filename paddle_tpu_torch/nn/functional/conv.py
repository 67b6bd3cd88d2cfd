"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py):
`conv1d/2d/3d` and `conv{1,2,3}d_transpose`, on PyTorch's convolution
(cuDNN on the card), as the reference runs XLA's convolution outside any
Pallas kernel.

Padding takes the reference's forms (`_padding`, a copy of its
resolver): "SAME", "VALID", an int, n values, 2n values (lo, hi per
spatial axis) and nested [(lo, hi)] * n, with or without the N and C
pairs. Symmetric pads go to the convolution; an asymmetric pair ("SAME"
at an even kernel or a stride among them) is padded with zeros first
(`F.pad`, which crops a negative pad) and the convolution runs with
none. Channels-last formats (NLC, NHWC, NDHWC) are moved to channels
first and back. The transpose's weight is [in, out / groups, *k], as in
both packages; its pads (lo, hi) and `output_padding` (high side only)
follow the reference's lhs-dilated form: where torch's transpose cannot
express them (asymmetric, or output_padding not below the stride or the
dilation) the transpose runs unpadded and its output is cropped or
zero-padded to the reference's. `output_size` is accepted and ignored,
as the reference ignores it (l.169-171).

Precision: an f32 convolution on the card runs in full f32, forward and
backward, whatever `torch.backends.cudnn.allow_tf32` says (cuDNN's
default is TF32): `_Conv` clears the flag around its own forward and
backward calls and restores it, so nothing process-wide changes. With
`FLAGS_cudnn_deterministic` on (set or in the environment) the same
calls run with `cudnn.deterministic` on and `cudnn.benchmark` off.
A bf16 convolution accumulates in f32 (cuDNN's and the CPU's kernels)
and rounds once, as the reference's `preferred_element_type` does.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ...framework import core

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    return v


def _padding(padding, n, strides, dilations, ksize, in_spatial):
    """The reference's padding spec -> [(lo, hi)] * n."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            pads = []
            for i in range(n):
                out = -(-in_spatial[i] // strides[i])
                eff_k = (ksize[i] - 1) * dilations[i] + 1
                total = max(0, (out - 1) * strides[i] + eff_k - in_spatial[i])
                pads.append((total // 2, total - total // 2))
            return pads
        raise ValueError(padding)
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if len(padding) == n + 2 and isinstance(padding[0], (list, tuple)):
        return [tuple(p) for p in padding[2:]]
    raise ValueError(f"bad padding {padding}")


def _pad_arg(pads):
    """[(lo, hi)] per spatial axis -> F.pad's list (last axis first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [int(lo), int(hi)]
    return out


@contextlib.contextmanager
def cudnn_scope(t):
    """The cuDNN settings a convolution of `t` runs under (module
    docstring): TF32 off for f32 on the card, deterministic algorithms
    under FLAGS_cudnn_deterministic; the previous settings restored."""
    if t.device.type != "cuda":
        yield
        return
    cd = torch.backends.cudnn
    prev = (cd.allow_tf32, cd.deterministic, cd.benchmark)
    if t.dtype == torch.float32:
        cd.allow_tf32 = False
    if core.get_bool_flag("FLAGS_cudnn_deterministic"):
        cd.deterministic, cd.benchmark = True, False
    try:
        yield
    finally:
        cd.allow_tf32, cd.deterministic, cd.benchmark = prev


class _Conv(torch.autograd.Function):
    """aten.convolution and its backward inside `cudnn_scope`."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        args = (stride, padding, dilation, transposed, output_padding,
                groups)
        with cudnn_scope(x):
            out = torch.ops.aten.convolution(x, w, b, *args)
        ctx.save_for_backward(x, w)
        ctx.args = args
        ctx.bias_shape = None if b is None else list(b.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.bias_shape is not None and ctx.needs_input_grad[2]]
        with cudnn_scope(x):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, ctx.bias_shape, *ctx.args, mask)
        return gx, gw, gb, None, None, None, None, None, None


def _channels_first(x, fmt):
    return torch.movedim(x, -1, 1) if fmt.endswith("C") else x


def _channels_back(x, fmt):
    return torch.movedim(x, 1, -1) if fmt.endswith("C") else x


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          n):
    fmt = data_format.upper()
    stride, dilation = _tup(stride, n), _tup(dilation, n)
    a = _channels_first(x, fmt)
    pads = _padding(padding, n, stride, dilation, tuple(weight.shape[2:]),
                    tuple(a.shape[2:]))
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        pad = tuple(int(lo) for lo, _ in pads)
    else:
        a = F.pad(a, _pad_arg(pads))
        pad = (0,) * n
    out = _Conv.apply(a, weight, bias, stride, pad, dilation, False,
                      (0,) * n, groups)
    return _channels_back(out, fmt)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, fmt, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n):
    fmt = data_format.upper().replace("L", "W")
    stride, dilation = _tup(stride, n), _tup(dilation, n)
    opad = (_tup(output_padding, n) if output_padding is not None
            else (0,) * n)
    a = _channels_first(x, fmt)
    ksize = tuple(weight.shape[2:])
    pads = _padding(padding, n, stride, dilation, ksize, tuple(a.shape[2:]))
    direct = all(
        lo == hi and 0 <= lo <= (k - 1) * d and (op < s or op < d)
        for (lo, hi), k, d, s, op in zip(pads, ksize, dilation, stride,
                                         opad))
    if direct:
        out = _Conv.apply(a, weight, bias, stride,
                          tuple(int(lo) for lo, _ in pads), dilation, True,
                          tuple(opad), groups)
        return _channels_back(out, fmt)
    # the unpadded transpose is the reference's lhs-dilated convolution
    # padded (eff_k - 1) a side; its pads are (eff_k - 1 - lo, eff_k - 1 -
    # hi + op): crop lo and hi - op (a negative amount pads zeros)
    out = _Conv.apply(a, weight, None, stride, (0,) * n, dilation, True,
                      (0,) * n, groups)
    out = F.pad(out, _pad_arg([(-lo, op - hi)
                               for (lo, hi), op in zip(pads, opad)]))
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * n)
    return _channels_back(out, fmt)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, fmt, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3)
