"""RMSNorm (counterpart of paddle_tpu/kernels/rms_norm.py).

`rms_norm(x, weight, eps)` launches the hand-written CUDA kernel
(`csrc/rms_norm.cu`) for a CUDA tensor and runs `_plain` — exactly the
reference's jnp expression (rms_norm.py:36-39) — for a CPU tensor. A
CUDA tensor the kernel cannot take raises; nothing falls back.
Forward only: the backward belongs to the training slice.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm", "supported"]

_MAX_ROW_BYTES = 48 * 1024      # the row is staged in static-limit smem


def supported(x_shape, dtype) -> bool:
    """Shapes/dtypes the kernel takes: a bf16/f32 row of H % 8 == 0
    elements that fits the kernel's shared-memory row buffer."""
    H = int(x_shape[-1])
    return (dtype in (torch.bfloat16, torch.float32) and H % 8 == 0
            and H * torch.finfo(dtype).bits // 8 <= _MAX_ROW_BYTES)


def _plain(x, weight, eps):
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def _launch(x, weight, eps):
    H = x.shape[-1]
    xf = x.contiguous()
    if xf.data_ptr() % 16:
        xf = xf.clone()
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(xf)
    rows = xf.numel() // H
    lib = _build.library()
    fn = (lib.ptt_rms_norm_bf16 if x.dtype == torch.bfloat16
          else lib.ptt_rms_norm_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(xf.data_ptr(), w.data_ptr(), y.data_ptr(), rows, H,
                        float(eps), stream), "rms_norm")
    rms_norm.launches += 1
    return y


def rms_norm(x, weight, eps=1e-6, use_kernel=None):
    """x: [..., H]; weight: [H] (f32). Returns x.dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape/dtype the kernel does not take."""
    ok = supported(x.shape, x.dtype) and weight.shape == x.shape[-1:]
    if use_kernel and not ok:
        raise ValueError(
            f"rms_norm: use_kernel=True but the kernel does not take x "
            f"{tuple(x.shape)} {x.dtype}, weight {tuple(weight.shape)} "
            f"(need bf16/f32, H % 8 == 0, H * itemsize <= "
            f"{_MAX_ROW_BYTES})")
    if x.device.type == "cpu":
        if use_kernel:
            raise ValueError("rms_norm: use_kernel=True needs a CUDA tensor")
        return _plain(x, weight, eps)
    if not ok:
        raise ValueError(
            f"rms_norm: no kernel for x {tuple(x.shape)} {x.dtype}")
    return _launch(x, weight, eps)


rms_norm.launches = 0
