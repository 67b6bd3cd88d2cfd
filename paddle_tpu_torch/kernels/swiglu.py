"""Fused SwiGLU MLP prologue, forward only (counterpart of
paddle_tpu/kernels/swiglu.py).

`swiglu(a, w_gate_up)` = silu(a @ Wg) * (a @ Wu) with w_gate_up = [Wg |
Wu] of shape [H, 2M] (gate columns first). A CUDA tensor launches the
hand-written kernel (`csrc/swiglu.cu`: the GEMM runs inside the kernel
and the [T, 2M] gate/up product is never stored); a CPU tensor runs
`_ref`, the reference's exact unfused expression (swiglu.py:106). The
kernel masks ragged edges, so unlike the TPU route it takes any H and M.
The backward belongs to the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["swiglu", "supported"]


def supported(a_shape, w_shape, dtype=torch.bfloat16) -> bool:
    """a: [..., H]; w_gate_up: [H, 2M] in bf16 or f32."""
    H, M2 = int(w_shape[0]), int(w_shape[1])
    return (len(w_shape) == 2 and int(a_shape[-1]) == H and M2 % 2 == 0
            and M2 > 0 and dtype in (torch.bfloat16, torch.float32))


def _ref(a, w_gate_up):
    """The exact unfused expression (LlamaMLP's fused-weight path)."""
    m = w_gate_up.shape[-1] // 2
    gu = a @ w_gate_up
    return F.silu(gu[..., :m]) * gu[..., m:]


def _launch(a, w_gate_up):
    H = a.shape[-1]
    M = w_gate_up.shape[-1] // 2
    af = a.reshape(-1, H).contiguous()
    w = w_gate_up.contiguous()
    T = af.shape[0]
    out = torch.empty((T, M), dtype=a.dtype, device=a.device)
    lib = _build.library()
    fn = (lib.ptt_swiglu_bf16 if a.dtype == torch.bfloat16
          else lib.ptt_swiglu_f32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _build.check(fn(af.data_ptr(), w.data_ptr(), out.data_ptr(), T, H, M,
                        stream), "swiglu")
    swiglu.launches += 1
    return out.reshape(*a.shape[:-1], M)


def swiglu(a, w_gate_up, use_kernel=None):
    """a: [..., H]; w_gate_up: [H, 2M]. Returns [..., M] in a.dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape/dtype the kernel does not take."""
    ok = (supported(a.shape, w_gate_up.shape, a.dtype)
          and w_gate_up.dtype == a.dtype)
    if use_kernel and not ok:
        raise ValueError(
            f"swiglu: use_kernel=True but the kernel does not take a "
            f"{tuple(a.shape)} {a.dtype}, w_gate_up "
            f"{tuple(w_gate_up.shape)} {w_gate_up.dtype} (need "
            f"a[-1] == H, an even column count, one bf16/f32 dtype)")
    if a.device.type == "cpu":
        if use_kernel:
            raise ValueError("swiglu: use_kernel=True needs a CUDA tensor")
        return _ref(a, w_gate_up)
    if not ok:
        raise ValueError(f"swiglu: no kernel for a {tuple(a.shape)} "
                         f"{a.dtype}, w {tuple(w_gate_up.shape)}")
    return _launch(a, w_gate_up)


swiglu.launches = 0
