"""Fused SwiGLU MLP prologue, forward and backward (counterpart of
paddle_tpu/kernels/swiglu.py).

`swiglu(a, w_gate_up)` = silu(a @ Wg) * (a @ Wu) with w_gate_up = [Wg |
Wu] of shape [H, 2M] (gate columns first). A CUDA tensor runs a
`torch.autograd.Function` over the hand-written kernels in
`csrc/swiglu.cu`: the forward (the GEMM runs inside the kernel and the
[T, 2M] gate/up product is never stored) and a backward of two launches,
`swiglu_bwd_da` (recompute g/u with the forward's main loop, form the
gate/up cotangents dgu in f32, then da = dgu @ w_gate_up^T) and
`swiglu_bwd_dw` (dw = a^T @ dgu). A CPU tensor runs the same
Function over `_ref`, the reference's exact unfused expression
(swiglu.py:106), with `_ref_bwd`, autograd of `_ref`, as its backward:
the reference's CPU backward is `jax.vjp(_ref)` (l.205-209). The
Function saves (a, w_gate_up) and nothing else, so a remat site
(framework/remat.py) can hand it a kept output as `out` and skip the
forward. The kernels mask ragged edges, so unlike the TPU route they
take any H and M.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["swiglu", "swiglu_bwd_da", "swiglu_bwd_dw", "supported"]


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


def _ref_bwd(a, w_gate_up, g):
    """The plain backward: autograd of `_ref`, (da, dw_gate_up)."""
    with torch.enable_grad():
        a_ = a.detach().requires_grad_()
        w_ = w_gate_up.detach().requires_grad_()
        return torch.autograd.grad(_ref(a_, w_), (a_, w_), g)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
        _build.check(fn(af.data_ptr(), w.data_ptr(), out.data_ptr(), T, H, M,
                        _stream(a)), "swiglu")
    swiglu.launches += 1
    return out.reshape(*a.shape[:-1], M)


def swiglu_bwd_da(a, w_gate_up, dout):
    """Kernel route of the backward, first launch: a [..., H], w_gate_up
    [H, 2M], dout [..., M] -> (da [..., H], dgu [T, 2M]); dgu = [dg | du]
    is the recomputed gate/up cotangent that `swiglu_bwd_dw` reads."""
    H = a.shape[-1]
    M = w_gate_up.shape[-1] // 2
    af = a.reshape(-1, H).contiguous()
    w = w_gate_up.contiguous()
    df = dout.reshape(-1, M).to(a.dtype).contiguous()
    T = af.shape[0]
    dgu = torch.empty((T, 2 * M), dtype=a.dtype, device=a.device)
    da = torch.empty((T, H), dtype=a.dtype, device=a.device)
    lib = _build.library()
    fn = (lib.ptt_swiglu_bwd_da_bf16 if a.dtype == torch.bfloat16
          else lib.ptt_swiglu_bwd_da_f32)
    with torch.cuda.device(a.device):
        _build.check(fn(af.data_ptr(), w.data_ptr(), df.data_ptr(),
                        dgu.data_ptr(), da.data_ptr(), T, H, M, _stream(a)),
                     "swiglu_bwd_da")
    swiglu_bwd_da.launches += 1
    return da.reshape(a.shape), dgu


def swiglu_bwd_dw(a, dgu):
    """Kernel route of the backward, second launch: a [..., H], dgu
    [T, 2M] -> dw_gate_up [H, 2M] = a^T @ dgu."""
    H = a.shape[-1]
    af = a.reshape(-1, H).contiguous()
    T, M2 = dgu.shape
    dw = torch.empty((H, M2), dtype=a.dtype, device=a.device)
    lib = _build.library()
    fn = (lib.ptt_swiglu_bwd_dw_bf16 if a.dtype == torch.bfloat16
          else lib.ptt_swiglu_bwd_dw_f32)
    with torch.cuda.device(a.device):
        _build.check(fn(af.data_ptr(), dgu.data_ptr(), dw.data_ptr(), T, H,
                        M2 // 2, _stream(a)), "swiglu_bwd_dw")
    swiglu_bwd_dw.launches += 1
    return dw


class _Swiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w_gate_up, out):
        ctx.save_for_backward(a, w_gate_up)
        if out is not None:
            return out
        if a.device.type == "cpu":
            return _ref(a, w_gate_up)
        return _launch(a, w_gate_up)

    @staticmethod
    def backward(ctx, g):
        a, w_gate_up = ctx.saved_tensors
        if a.device.type == "cpu":
            return (*_ref_bwd(a, w_gate_up, g), None)
        da, dgu = swiglu_bwd_da(a, w_gate_up, g)
        return da, swiglu_bwd_dw(a, dgu), None


def swiglu(a, w_gate_up, use_kernel=None, out=None):
    """a: [..., H]; w_gate_up: [H, 2M]. Returns [..., M] in a.dtype.

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape/dtype the kernel does not take. `out`: this call's output,
    kept by a remat site; it is returned with the backward attached and
    nothing is computed."""
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
    elif not ok:
        raise ValueError(f"swiglu: no kernel for a {tuple(a.shape)} "
                         f"{a.dtype}, w {tuple(w_gate_up.shape)}")
    return _Swiglu.apply(a, w_gate_up, out)


swiglu.launches = 0
swiglu_bwd_da.launches = 0
swiglu_bwd_dw.launches = 0
