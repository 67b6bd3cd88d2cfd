"""Flash attention, BSHD in and out (counterpart of
paddle_tpu/kernels/flash_attention.py::flash_attention_bshd).

A CUDA tensor runs a `torch.autograd.Function` over the hand-written
kernels in `csrc/flash_attention.cu`: `flash_attention_fwd` (O and the
f32 log-sum-exp) and `flash_attention_bwd` (the dkv and dq kernels,
which recompute P from the saved LSE; D = rowsum(dO * O) is plain
PyTorch over the stored O, as upstream's l.1664 is plain jnp). A CPU
tensor runs `_plain`, the reference's dense `_sdpa` (models/llama.py:
190-200: f32 scores and softmax, `jnp.repeat` of the kv heads for GQA)
under autograd — what the reference's model runs on the CPU. A CUDA
tensor the kernels cannot take raises; nothing falls back.

Scale follows the reference's two TPU routes: MHA applies `scale` to the
f32 scores inside the kernel (upstream `flash_attention(sm_scale=)`);
GQA pre-scales q in q's dtype (`_splash_gqa`, flash_attention.py:131)
and the kernel runs with scale 1. Padding masks and additive biases
(the packed and biased routes) are not ported.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention_bshd", "flash_attention_fwd",
           "flash_attention_bwd", "supported"]


def supported(q_shape, k_shape, causal_or_none: bool,
              has_padding_mask: bool = False, has_bias: bool = False,
              dtype=torch.bfloat16) -> bool:
    """Shapes the kernels take: q [B, S, Hq, D], k [B, S, Hk, D] with one
    sequence length, Hq a multiple of Hk, D in {64, 128}, bf16/f32,
    causal or no mask, no padding mask, no bias."""
    B, Sq, Hq, D = (int(s) for s in q_shape)
    Bk, Sk, Hk, Dk = (int(s) for s in k_shape)
    return (causal_or_none and not has_padding_mask and not has_bias
            and dtype in (torch.bfloat16, torch.float32)
            and (B, Sq, D) == (Bk, Sk, Dk) and D in (64, 128)
            and Hk > 0 and Hq % Hk == 0)


def _scores(q, k, causal, scale):
    """f32 [B, Hq, Sq, Sk] scaled scores with the causal mask aligned
    bottom-right (tril(k=Sk-Sq)), kv heads repeated for GQA."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
    s = q.transpose(1, 2).float() @ k.transpose(1, 2).float().transpose(-1, -2)
    s = s / math.sqrt(q.shape[-1]) if scale is None else s * scale
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=s.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _plain(q, k, v, causal, scale=None):
    """The reference's `_sdpa` generalised to a full mask and an explicit
    scale: f32 dense scores and softmax, output in q's dtype."""
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    group = q.shape[2] // v.shape[2]
    if group > 1:
        v = torch.repeat_interleave(v, group, dim=2)
    return (p @ v.transpose(1, 2).float()).transpose(1, 2).to(q.dtype)


def _plain_lse(q, k, causal, scale=None):
    """The f32 log-sum-exp [B, Hq, S] of `_plain`'s scores (what the
    forward kernel saves for the backward)."""
    return torch.logsumexp(_scores(q, k, causal, scale), dim=-1)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fn(lib, name, dtype):
    return getattr(lib, f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")


def _rows(t):
    """Contiguous with a 16-byte aligned base: the kernels copy rows in
    16-byte vectors."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention_fwd(q, k, v, causal, scale):
    """Kernel route, forward: q [B, S, Hq, D], k/v [B, S, Hk, D] ->
    (o [B, S, Hq, D] in q's dtype, lse [B, Hq, S] f32). `scale`
    multiplies the f32 scores."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    q, k, v = (_rows(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, "ptt_flash_attention_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, Hq, Hk, D, int(bool(causal)), float(scale),
            _stream(q)), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal, scale):
    """Kernel route, backward (the dkv and dq kernels in one launch
    entry): the forward's inputs, its o and lse, and the output
    cotangent do -> (dq, dk, dv). D = rowsum(do * o) in f32 is computed
    here in plain PyTorch from the stored o."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    q, k, v, o = (_rows(t) for t in (q, k, v, o))
    do = _rows(do.to(q.dtype))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, "ptt_flash_attention_bwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, Hq, Hk, D, int(bool(causal)), float(scale),
            _stream(q)), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None,
                         padding_mask=None, bias=None, use_kernel=None):
    """[batch, seq, heads, dim] in and out. GQA/MQA when q has a multiple
    of k's heads. scale: None = 1/sqrt(dim).

    use_kernel=None routes by device (kernels on CUDA, `_plain` on CPU);
    True demands the kernels and raises ValueError for a CPU tensor or a
    shape/dtype they do not take."""
    if padding_mask is not None or bias is not None:
        raise NotImplementedError(
            "flash_attention_bshd: padding_mask= and bias= (the packed and "
            "biased routes, PERF.md kernel rows 11-12) are not ported yet")
    ok = (supported(q.shape, k.shape, True, dtype=q.dtype)
          and k.shape == v.shape and k.dtype == v.dtype == q.dtype)
    if use_kernel and not ok:
        raise ValueError(
            f"flash_attention_bshd: use_kernel=True but the kernels do not "
            f"take q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (need one bf16/f32 dtype, equal batch and "
            f"seq, D in (64, 128), q heads a multiple of kv heads)")
    if q.device.type == "cpu":
        if use_kernel:
            raise ValueError(
                "flash_attention_bshd: use_kernel=True needs a CUDA tensor")
        return _plain(q, k, v, causal, scale)
    if not ok:
        raise ValueError(f"flash_attention_bshd: no kernel for q "
                         f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[2] != k.shape[2]:
        # splash's convention: q pre-scaled in its own dtype
        return _FlashAttention.apply((q * scale).to(q.dtype), k, v,
                                     bool(causal), 1.0)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
