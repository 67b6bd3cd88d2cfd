"""Fused residual add + RMSNorm (counterpart of
paddle_tpu/kernels/fused_norm_residual.py).

`fused_add_rms_norm(x, residual, weight, eps)` returns (y, h) with
h = x + residual (rounded to the stream dtype) and y = rms_norm(h) *
weight. A CUDA tensor launches the hand-written kernel
(`csrc/fused_norm_residual.cu`: one pass reads x and residual once and
writes both outputs); a CPU tensor runs `_plain`, the reference's jnp
fallback (fused_norm_residual.py:119-127), which is the unfused add and
RMSNorm float for float. A CUDA tensor the kernel cannot take raises;
nothing falls back. The backward is the reference's analytic
`_fused_bwd` (l.167-182) in plain PyTorch: it recomputes the rstd from
the saved h and returns the same dh for x and residual, accumulated in
the stream dtype.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_add_rms_norm", "supported"]

_MAX_ROW_BYTES = 48 * 1024      # the row of h is staged in static-limit smem


def supported(shape, dtype=torch.bfloat16) -> bool:
    """x/residual: [..., H] in bf16/f32 with H % 8 == 0 and a row that
    fits the kernel's shared-memory buffer."""
    H = int(shape[-1])
    return (dtype in (torch.bfloat16, torch.float32) and H % 8 == 0
            and H * torch.finfo(dtype).bits // 8 <= _MAX_ROW_BYTES)


def _plain(x, residual, weight, eps):
    h = x + residual
    h32 = h.float()
    ms = torch.mean(h32 * h32, dim=-1, keepdim=True)
    y = (h32 * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)
    return y, h


def _bwd(h, weight, gy, gh, eps):
    """The reference's `_fused_bwd`: dh = dnorm + gh in the stream dtype
    (dx = dresidual = dh), dw = sum_rows(gy * h * r) in f32."""
    H = h.shape[-1]
    h32 = h.float()
    gy32 = gy.float()
    w32 = weight.float()
    r = torch.rsqrt(torch.mean(h32 * h32, dim=-1, keepdim=True) + eps)
    gw = gy32 * w32
    dnorm = r * gw - h32 * (r ** 3) * torch.sum(gw * h32, dim=-1,
                                                keepdim=True) / H
    dh = dnorm.to(h.dtype) + gh
    dw = torch.sum((gy32 * h32 * r).reshape(-1, H), dim=0).to(weight.dtype)
    return dh, dw


def _launch(x, residual, weight, eps):
    H = x.shape[-1]
    xf = x.contiguous()
    rf = residual.contiguous()
    if xf.data_ptr() % 16:
        xf = xf.clone()
    if rf.data_ptr() % 16:
        rf = rf.clone()
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(xf)
    h = torch.empty_like(xf)
    rows = xf.numel() // H
    lib = _build.library()
    fn = (lib.ptt_fused_add_rms_norm_bf16 if x.dtype == torch.bfloat16
          else lib.ptt_fused_add_rms_norm_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(xf.data_ptr(), rf.data_ptr(), w.data_ptr(),
                        y.data_ptr(), h.data_ptr(), rows, H, float(eps),
                        stream), "fused_add_rms_norm")
    fused_add_rms_norm.launches += 1
    return y, h


class _FusedAddRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        if x.device.type == "cpu":
            y, h = _plain(x, residual, weight, eps)
        else:
            y, h = _launch(x, residual, weight, eps)
        ctx.save_for_backward(h, weight)
        ctx.eps = eps
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        h, weight = ctx.saved_tensors
        dh, dw = _bwd(h, weight, gy, gh, ctx.eps)
        return dh, dh, dw, None


def fused_add_rms_norm(x, residual, weight, eps=1e-6, use_kernel=None):
    """x, residual: [..., H] in one dtype; weight: [H] (f32). Returns
    (y, h), both in x's dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape/dtype the kernel does not take."""
    ok = (supported(x.shape, x.dtype) and residual.shape == x.shape
          and residual.dtype == x.dtype and weight.shape == x.shape[-1:])
    if use_kernel and not ok:
        raise ValueError(
            f"fused_add_rms_norm: use_kernel=True but the kernel does not "
            f"take x {tuple(x.shape)} {x.dtype}, residual "
            f"{tuple(residual.shape)} {residual.dtype}, weight "
            f"{tuple(weight.shape)} (need one bf16/f32 dtype, H % 8 == 0, "
            f"H * itemsize <= {_MAX_ROW_BYTES})")
    if x.device.type == "cpu":
        if use_kernel:
            raise ValueError(
                "fused_add_rms_norm: use_kernel=True needs a CUDA tensor")
    elif not ok:
        raise ValueError(f"fused_add_rms_norm: no kernel for x "
                         f"{tuple(x.shape)} {x.dtype}, residual "
                         f"{tuple(residual.shape)} {residual.dtype}")
    return _FusedAddRmsNorm.apply(x, residual, weight, eps)


fused_add_rms_norm.launches = 0
