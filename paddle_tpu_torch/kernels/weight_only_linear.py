"""Weight-only int8 linear, W8A16 (no Pallas counterpart: the reference
dequantizes in the serving step's trace and XLA fuses the convert and
the scale into the dot's operand read, paddle_tpu/inference/
serving.py:263-268; paddle_tpu/incubate/nn/functional/__init__.py:352).

`weight_only_linear(a, q, scale)` = a @ deq(q) with q int8 [K, N] in the
[in, out] layout and deq(q)[k, n] = f32(q[k, n]) * s[k // group, n]
rounded once to a's dtype. `scale` is per column ([N] or [1, N]), per
tensor (one value) or per group ([K / group, N]). `swiglu=True` reads q as
[Qg | Qu] [K, 2M] and returns silu(a @ deq(Qg)) * (a @ deq(Qu)) [.., M].

A CUDA tensor launches the hand-written kernel in
`csrc/weight_only_linear.cu` (bf16 or f16 activations, f32 scales; the
int8 bytes are read once and no dequantized weight is stored); a CPU
tensor runs `_plain`: the dequantized weight in the same float order,
then the product (and for SwiGLU the unfused expression of
`kernels/swiglu.py::_ref`), which is what the reference computes on the
CPU. On the card a scale layout or dtype the kernel does not take
raises; nothing falls back to the plain route.

`QuantWeight` is the (int8, scale) pair of the serving state
(`inference.serving.quantize_state_int8`); `matmul(a, w)` is a @ w for
a tensor and this kernel for a `QuantWeight`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from . import swiglu as ksw

__all__ = ["QuantWeight", "dequantize", "matmul", "supported",
           "weight_only_linear"]

# the kernel's K step: a scale group must hold whole steps
_TK = 64


class QuantWeight(NamedTuple):
    """An int8 weight [K, N] in the [in, out] layout and its f32 scale
    (per column [1, N] from the serving rule)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def columns(self, start, stop):
        """Columns [start, stop) of the weight: codes and their scales
        (per-column scales follow their columns)."""
        s = self.scale
        if s.numel() > 1:
            s = s[..., start:stop]
        return QuantWeight(self.q[:, start:stop], s)

    @staticmethod
    def cat(parts):
        """Column concatenation of per-column quantized weights: equal to
        quantizing the concatenated weight, since each column's scale is
        its own."""
        return QuantWeight(torch.cat([p.q for p in parts], dim=-1),
                           torch.cat([p.scale.reshape(1, -1)
                                      for p in parts], dim=-1))


def _scale_layout(q_shape, s_shape):
    """(group, row stride, column stride) of the scale of a [K, N]
    weight, or None for a layout no route takes."""
    K, N = int(q_shape[0]), int(q_shape[1])
    numel = 1
    for d in s_shape:
        numel *= int(d)
    if numel == 1:
        return max(K, 1), 0, 0
    if tuple(s_shape) in ((N,), (1, N)):
        return max(K, 1), 0, 1
    if (len(s_shape) == 2 and int(s_shape[1]) == N and int(s_shape[0]) > 1
            and K % int(s_shape[0]) == 0):
        return K // int(s_shape[0]), N, 1
    return None


def supported(a_shape, q_shape, scale_shape, dtype=torch.bfloat16,
              swiglu=False, bias=None) -> bool:
    """Whether the kernel takes a [..., K] in `dtype` against an int8
    [K, N] weight with this scale: bf16 or f16, a per-column, per-tensor
    or per-group scale whose groups hold whole 64-row steps, an even N
    for SwiGLU, a bias [N] in a's dtype (plain epilogue only)."""
    if len(q_shape) != 2 or int(a_shape[-1]) != int(q_shape[0]):
        return False
    lay = _scale_layout(q_shape, scale_shape)
    if lay is None or dtype not in (torch.bfloat16, torch.float16):
        return False
    if lay[1] != 0 and lay[0] % _TK:
        return False
    if swiglu and (int(q_shape[1]) % 2 or bias is not None):
        return False
    return bias is None or (bias.dtype == dtype
                            and tuple(bias.shape) == (int(q_shape[1]),))


def dequantize(q, scale, dtype):
    """The dequantized weight [K, N] in `dtype`: f32 codes times the f32
    scale, rounded once (the serving engine's order,
    quantization.comm.dequantize_channelwise). A group scale [K / g, N]
    expands over its g rows."""
    if scale.dim() == 2 and scale.shape[0] > 1:
        K, N = q.shape
        G = scale.shape[0]
        qg = q.reshape(G, K // G, N)
        return (qg.float() * scale.float()[:, None, :]).reshape(K, N).to(dtype)
    return (q.float() * scale.float()).to(dtype)


def _plain(a, q, scale, bias, swiglu):
    w = dequantize(q, scale, a.dtype)
    if swiglu:
        return ksw._ref(a, w)
    out = a @ w
    return out if bias is None else out + bias


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(a, q, scale, bias, swiglu):
    K, N = int(q.shape[0]), int(q.shape[1])
    group, s_rs, s_cs = _scale_layout(q.shape, scale.shape)
    af = a.reshape(-1, K).contiguous()
    qc = q.contiguous()
    s = scale.float().contiguous()
    M = af.shape[0]
    Nv = N // 2 if swiglu else N
    out = torch.empty((M, Nv), dtype=a.dtype, device=a.device)
    if M == 0 or Nv == 0:
        return out.reshape(*a.shape[:-1], Nv)
    lib = _build.library()
    f16 = a.dtype == torch.float16
    with torch.cuda.device(a.device):
        if swiglu:
            fn = (lib.ptt_weight_only_swiglu_f16 if f16
                  else lib.ptt_weight_only_swiglu_bf16)
            err = fn(af.data_ptr(), qc.data_ptr(), s.data_ptr(),
                     out.data_ptr(), M, K, Nv, group, s_rs, s_cs, _stream(a))
        else:
            fn = (lib.ptt_weight_only_linear_f16 if f16
                  else lib.ptt_weight_only_linear_bf16)
            bp = None if bias is None else bias.contiguous().data_ptr()
            err = fn(af.data_ptr(), qc.data_ptr(), s.data_ptr(), bp,
                     out.data_ptr(), M, K, Nv, group, s_rs, s_cs, _stream(a))
        _build.check(err, "weight_only_linear")
    weight_only_linear.launches += 1
    return out.reshape(*a.shape[:-1], Nv)


def weight_only_linear(a, q, scale, bias=None, swiglu=False,
                       use_kernel=None):
    """a: [..., K]; q: int8 [K, N]; scale: [N], [1, N], one value or
    [K / g, N]; bias: optional [N]. Returns [..., N] (SwiGLU: [..., N /
    2]) in a's dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or an
    input the kernel does not take."""
    ok = (q.dtype == torch.int8 and q.device == a.device
          and supported(a.shape, q.shape, scale.shape, a.dtype, swiglu,
                        bias))
    if use_kernel and not ok:
        raise ValueError(
            f"weight_only_linear: use_kernel=True but the kernel does not "
            f"take a {tuple(a.shape)} {a.dtype}, q {tuple(q.shape)} "
            f"{q.dtype}, scale {tuple(scale.shape)} (need bf16/f16, an "
            f"int8 [K, N] weight, a per-column, per-tensor or 64-row "
            f"group scale, an even N for SwiGLU)")
    if _scale_layout(q.shape, scale.shape) is None:
        raise ValueError(f"weight_only_linear: no scale layout for q "
                         f"{tuple(q.shape)} and scale {tuple(scale.shape)}")
    if a.device.type == "cpu":
        if use_kernel:
            raise ValueError(
                "weight_only_linear: use_kernel=True needs a CUDA tensor")
        return _plain(a, q, scale, bias, swiglu)
    if not ok:
        raise ValueError(
            f"weight_only_linear: no kernel for a {tuple(a.shape)} "
            f"{a.dtype}, q {tuple(q.shape)} {q.dtype}, scale "
            f"{tuple(scale.shape)}")
    return _launch(a, q, scale, bias, swiglu)


weight_only_linear.launches = 0


def matmul(a, w):
    """a @ w for a weight tensor; the W8A16 product (engine order) for a
    `QuantWeight`."""
    if isinstance(w, QuantWeight):
        return weight_only_linear(a, w.q, w.scale)
    return a @ w
