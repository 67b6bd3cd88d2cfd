"""Per-channel int8 rule of the weight-only serving path (counterpart of
paddle_tpu/quantization/comm.py:148-162, `channelwise_absmax_int8` and
`dequantize_channelwise`).

Rounding is half to even on both sides (`jnp.round`, `torch.round`),
codes are clipped to [-127, 127] (the -128 code stays unused, so
negation round-trips), and each channel's scale is max(absmax / 127,
1e-8) in f32, kept with its axis so that `q * scale` broadcasts back.
The blockwise wire format of the quantized collectives is not ported
yet.
"""
from __future__ import annotations

import torch

__all__ = ["channelwise_absmax_int8", "dequantize_channelwise"]


def channelwise_absmax_int8(arr, axis: int = 0):
    """Per-channel absmax int8 quantization: one f32 scale per channel
    (reduced over `axis`, kept as a size-1 axis). Returns (q_int8,
    scale_f32)."""
    a32 = arr.float()
    scale = torch.amax(torch.abs(a32), dim=axis, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(a32 / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_channelwise(q, scale, dtype):
    """Inverse of `channelwise_absmax_int8` in the compute dtype: f32
    codes times the f32 scale, rounded once to `dtype`."""
    return (q.float() * scale).to(dtype)
