"""Flash attention, BSHD in and out (counterpart of
paddle_tpu/kernels/flash_attention.py: `flash_attention_bshd`, its
padding-mask and bias routes, `flash_attention_packed` and
`flash_attention_biased`).

A CUDA tensor runs a `torch.autograd.Function` over hand-written
kernels: `flash_attention_fwd` (O and the f32 log-sum-exp) and
`flash_attention_bwd` (the delta pre-pass `flash_attention_delta`, D =
rowsum(dO * O) in f32 over the stored O, then the dkv and dq kernels,
which recompute P from the saved LSE). They run the TMA + mbarrier +
wgmma core of `csrc/flash_wgmma.cu`: bf16 on the tensor cores in bf16,
f32 in 3xTF32 (every f32 operand split into two tf32 parts, three tf32
products a product; chip_smoke.py's `expected_flash_routes` states the
rule and holds the card's launches to it). A CPU
tensor runs `_plain`, the reference's dense `_sdpa` (models/llama.py:
190-200: f32 scores and softmax, `jnp.repeat` of the kv heads for GQA)
under autograd — what the reference's model runs on the CPU. A CUDA
tensor the kernels cannot take raises; nothing falls back.

Scale follows the reference's two TPU routes: MHA applies `scale` to the
f32 scores inside the kernel (upstream `flash_attention(sm_scale=)`);
GQA pre-scales q in q's dtype (`_splash_gqa`, flash_attention.py:131)
and the kernel runs with scale 1.

Segment ids (`padding_mask=`, `flash_attention_packed`, and q and kv
lengths that differ): `flash_attention_seg_fwd` runs the wgmma core's
forward with int32 segment ids (bf16; f32 on its 3xTF32 form, three
tf32 products a product, on the tensor cores too), skipping the kv tiles
no pair of whose can share a segment (`testing.seg_visit_plan` mirrors
the rule). The backward is the delta pre-pass `flash_attention_delta`,
then `flash_attention_seg_dkv` and `flash_attention_seg_dq`: the wgmma
core's dkv and dq with ids and two lengths (f32: their 3xTF32 form),
each skipping the tiles its own plan proves empty
(`testing.seg_dkv_visit_plan` and `seg_visit_plan` at `SEG_BWD_TILES`;
chip_smoke.py's `expected_seg_routes`). A score counts where the q and
kv segments are equal. A padding mask [B, Sk] lowers to segment ids as
the reference lowers it (l.327-336, GQA l.136-139): kv_seg = mask, q_seg
= kv_seg when Sq == Sk, else all ones. So a padded query row attends to
the padded keys only, as on the TPU. That guess reads equal lengths as
self-attention; `mask_queries=False` takes q_seg = all ones whatever the
lengths, a mask of the keys alone (what `nn.functional`'s sdpa passes,
as its reference's dense route masks keys only). A query row with no
key of its own segment averages V over all keys (upstream's finite
mask value), and its
backward recomputes P = 1 from an LSE that rounds to that value, as
upstream's does. `_SegPlain` is that function in plain PyTorch, with the
flash backward written out. Causal with Sq != Sk is not ported (upstream
aligns that mask top-left, the port's dense route bottom-right).

Bias (`bias=`, `flash_attention_biased`): the kernels of
`csrc/flash_attention.cu` (bf16 on mma.sync, f32 on SIMT) with a bias
made or read at the score assembly (`flash_attention_bias_fwd`,
`flash_attention_bias_dkv`, `flash_attention_bias_dq`; `_bias_args`
lowers "alibi" slopes, a "rel_table" and a "dense" bias to the kernels'
arguments), never materialised. x = s * scale + bias in f32 (GQA too:
kv heads read natively, q not pre-scaled); an entry is masked past Sk,
above the top-left causal diagonal (any Sq and Sk), at a padding-mask
key or where the bias is <= -5e29; a row with no valid key gives o = 0
and lse = +inf. D = rowsum(dO * O) is plain PyTorch. `_biased_plain_fwd`
and `_biased_plain_bwd` are that function in plain PyTorch over KV
chunks (`_bias_chunk`), the CPU route and the kernels' yardstick; no
[B, H, Sq, Sk] buffer exists in either. The bias parameter's gradient
is a plain chunked pass (`_biased_plain_dparam`) on both devices.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = ["flash_attention_bshd", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_delta",
           "flash_attention_seg_fwd",
           "flash_attention_seg_dkv", "flash_attention_seg_dq",
           "flash_attention_packed", "flash_attention_biased",
           "flash_attention_bias_fwd", "flash_attention_bias_dkv",
           "flash_attention_bias_dq", "packed_supported", "supported"]

# upstream's DEFAULT_MASK_VALUE: the score of a key in another segment
_SEG_MASK = -0.7 * torch.finfo(torch.float32).max
_NEG = -1e30


def supported(q_shape, k_shape, causal_or_none: bool,
              has_padding_mask: bool = False, has_bias: bool = False,
              dtype=torch.bfloat16) -> bool:
    """Shapes the kernels take: q [B, Sq, Hq, D], k [B, Sk, Hk, D] with
    Hq a multiple of Hk, D in {64, 128}, bf16/f32. With a bias (the
    bias kernels) any mask goes; without one the mask is causal or
    absent, as the reference's gate asks (`causal_or_none`), and a
    padding mask rides segment ids. Causal with Sq != Sk raises
    NotImplementedError at the call, except on the bias route."""
    B, Sq, Hq, D = (int(s) for s in q_shape)
    Bk, Sk, Hk, Dk = (int(s) for s in k_shape)
    base = (dtype in (torch.bfloat16, torch.float32) and B == Bk
            and D == Dk and D in (64, 128) and Sq > 0 and Sk > 0
            and Hk > 0 and Hq % Hk == 0)
    del has_padding_mask  # segment ids: never gated out
    return base and (has_bias or causal_or_none)


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


def flash_attention_delta(o, do):
    """Kernel route, the backward's pre-pass: D = rowsum(do * o) in f32
    from the BSHD output o and its cotangent do (one dtype, D in {64,
    128}) -> [B, H, S], reading each once. A CPU tensor takes the plain
    version, `_delta`."""
    if o.device.type == "cpu":
        return _delta(o, do)
    B, S, H, D = o.shape
    o, do = _rows(o), _rows(do.to(o.dtype))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=o.device)
    lib = _build.library()
    with torch.cuda.device(o.device):
        _build.check(_fn(lib, "ptt_flash_attention_delta", o.dtype)(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, S, H, D,
            _stream(o)), "flash_attention_delta")
    flash_attention_delta.launches += 1
    return delta


def flash_attention_bwd(q, k, v, o, lse, do, causal, scale):
    """Kernel route, backward: the forward's inputs, its o and lse, and
    the output cotangent do -> (dq, dk, dv). Launches the delta pre-pass
    (`flash_attention_delta`), then the dkv and dq kernels (one launch
    entry)."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    q, k, v, o = (_rows(t) for t in (q, k, v, o))
    do = _rows(do.to(q.dtype))
    delta = flash_attention_delta(o, do)
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


# ------------------------------------------------------- segment ids


def _seg_scores(q, k, seg_q, seg_kv, causal, scale):
    """`_scores` with segment ids: the segment mask value where seg_q[b, i]
    != seg_kv[b, j], then -inf above the causal diagonal (Sq == Sk)."""
    s = _scores(q, k, False, scale)
    same = seg_q[:, None, :, None] == seg_kv[:, None, None, :]
    s = torch.where(same, s, torch.full_like(s, _SEG_MASK))
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        vis = torch.ones((Sq, Sk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~vis, float("-inf"))
    return s


def _group_sum(t, group):
    """[B, Hq, S, D] -> [B, Hq / group, S, D], summing each kv head's
    group of q heads."""
    if group == 1:
        return t
    B, H, S, D = t.shape
    return t.view(B, H // group, group, S, D).sum(2)


class _SegPlain(torch.autograd.Function):
    """The segment kernels' function in plain PyTorch, f32 inside: the
    softmax forward (and its f32 LSE), and the flash backward written out
    (P recomputed as exp(s - LSE), D = rowsum(dO * O) over the output in
    q's dtype), which the kernels run too."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, scale):
        s = _seg_scores(q, k, seg_q, seg_kv, causal, scale)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        group = q.shape[2] // v.shape[2]
        vh = v.transpose(1, 2).float()
        if group > 1:
            vh = vh.repeat_interleave(group, dim=1)
        o = (p @ vh).transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, o, lse = ctx.saved_tensors
        group = q.shape[2] // k.shape[2]
        s = _seg_scores(q, k, seg_q, seg_kv, ctx.causal, ctx.scale)
        p = torch.exp(s - lse[..., None])
        qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
        if group > 1:
            kh, vh = (t.repeat_interleave(group, dim=1) for t in (kh, vh))
        doh = do.transpose(1, 2).float()
        delta = (doh * o.transpose(1, 2).float()).sum(-1, keepdim=True)
        ds = p * (doh @ vh.transpose(-1, -2) - delta)
        dq = (ds @ kh) * ctx.scale
        dk = _group_sum(ds.transpose(-1, -2) @ qh, group) * ctx.scale
        dv = _group_sum(p.transpose(-1, -2) @ doh, group)
        return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None, None, None, None)


def _seg_ptrs(seg_q, seg_kv):
    if seg_q is None:
        return None, None
    return seg_q.data_ptr(), seg_kv.data_ptr()


def flash_attention_seg_fwd(q, k, v, seg_q, seg_kv, causal, scale):
    """Kernel route, forward, with q and kv lengths of their own: q
    [B, Sq, Hq, D], k/v [B, Sk, Hk, D], seg_q [B, Sq] and seg_kv [B, Sk]
    int32 (or both None) -> (o [B, Sq, Hq, D] in q's dtype, lse
    [B, Hq, Sq] f32). One launch of csrc/flash_wgmma.cu's forward (f32:
    its 3xTF32 form)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    q, k, v = (_rows(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, "ptt_flash_attention_seg_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *_seg_ptrs(seg_q, seg_kv),
            o.data_ptr(), lse.data_ptr(), B, Sq, Sk, Hq, Hk, D,
            int(bool(causal)), float(scale), _stream(q)),
            "flash_attention_seg_fwd")
    flash_attention_seg_fwd.launches += 1
    return o, lse


def _delta(o, do):
    """D = rowsum(do * o) in f32, [B, H, S]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_seg_dkv(q, k, v, do, lse, delta, seg_q, seg_kv, causal,
                            scale):
    """Kernel route, backward dk and dv (one launch): the forward's
    inputs, its lse, the output cotangent do and D (the delta pre-pass's)
    -> (dk, dv)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    q, k, v, do = (_rows(t) for t in (q, k, v, do))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, "ptt_flash_attention_seg_dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(seg_q, seg_kv),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hk, D,
            int(bool(causal)), float(scale), _stream(q)),
            "flash_attention_seg_dkv")
    flash_attention_seg_dkv.launches += 1
    return dk, dv


def flash_attention_seg_dq(q, k, v, do, lse, delta, seg_q, seg_kv, causal,
                           scale):
    """Kernel route, backward dq (one launch)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    q, k, v, do = (_rows(t) for t in (q, k, v, do))
    dq = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, "ptt_flash_attention_seg_dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(seg_q, seg_kv),
            dq.data_ptr(), B, Sq, Sk, Hq, Hk, D, int(bool(causal)),
            float(scale), _stream(q)), "flash_attention_seg_dq")
    flash_attention_seg_dq.launches += 1
    return dq


class _SegFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, scale):
        o, lse = flash_attention_seg_fwd(q, k, v, seg_q, seg_kv, causal,
                                         scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = flash_attention_delta(o, do)
        args = (q, k, v, do, lse, delta, seg_q, seg_kv, ctx.causal,
                ctx.scale)
        dk, dv = flash_attention_seg_dkv(*args)
        dq = flash_attention_seg_dq(*args)
        return dq, dk, dv, None, None, None, None


def _kernel_takes(q, k, v, causal):
    return (supported(q.shape, k.shape, True, dtype=q.dtype)
            and k.shape == v.shape and k.dtype == v.dtype == q.dtype
            and not (causal and q.shape[1] != k.shape[1]))


def _attend(q, k, v, seg_q, seg_kv, causal, scale, use_kernel,
            what="flash_attention_bshd"):
    """q [B, Sq, Hq, D] against k/v [B, Sk, Hk, D], under segment ids
    (int32 [B, Sq] and [B, Sk]) or none. CUDA: the one-length kernels
    without ids (`_FlashAttention`), the segment kernels otherwise
    (`_SegFlash`); CPU: `_plain` without ids, `_SegPlain` with them."""
    if causal and q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            f"{what}: causal attention with q length {q.shape[1]} != kv "
            f"length {k.shape[1]} is not ported")
    ok = _kernel_takes(q, k, v, causal)
    if use_kernel and not ok:
        raise ValueError(
            f"{what}: use_kernel=True but the kernels do not take q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (need one bf16/f32 dtype, equal batch, D in "
            f"(64, 128), q heads a multiple of kv heads)")
    if q.device.type == "cpu":
        if use_kernel:
            raise ValueError(f"{what}: use_kernel=True needs a CUDA tensor")
    elif not ok:
        raise ValueError(f"{what}: no kernel for q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and seg_q is None:
        # the reference's dense `_sdpa`: f32 scores scaled in f32
        return _plain(q, k, v, causal, scale)
    if q.shape[2] != k.shape[2]:
        # splash's convention: q pre-scaled in its own dtype
        q, scale = (q * scale).to(q.dtype), 1.0
    if seg_q is None:
        if q.shape[1] == k.shape[1]:
            return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
        return _SegFlash.apply(q, k, v, None, None, bool(causal),
                               float(scale))
    seg_q, seg_kv = (t.to(device=q.device, dtype=torch.int32).contiguous()
                     for t in (seg_q, seg_kv))
    fn = _SegPlain if q.device.type == "cpu" else _SegFlash
    return fn.apply(q, k, v, seg_q, seg_kv, bool(causal), float(scale))


def padding_segments(padding_mask, Sq, Sk, mask_queries=None):
    """The lowering of a [B, Sk] validity mask: kv_seg = mask (1 valid, 0
    padding); q_seg = kv_seg where the queries share the keys' padding,
    else all ones. mask_queries=None: the reference's rule, shared when
    Sq == Sk; False: all ones (a mask of the keys alone, right for
    cross-attention at any lengths). Returns int32 (q_seg [B, Sq], kv_seg
    [B, Sk])."""
    kv_seg = padding_mask.bool().to(torch.int32)
    if mask_queries is None:
        mask_queries = Sq == Sk
    q_seg = kv_seg if mask_queries else torch.ones(
        (kv_seg.shape[0], Sq), dtype=torch.int32, device=kv_seg.device)
    return q_seg, kv_seg


def flash_attention_bshd(q, k, v, causal=False, scale=None,
                         padding_mask=None, bias=None, use_kernel=None,
                         mask_queries=None):
    """[batch, seq, heads, dim] in and out. GQA/MQA when q has a multiple
    of k's heads. scale: None = 1/sqrt(dim).

    padding_mask: optional [batch, kv_seq] bool/int, True/1 = valid —
    lowered to segment ids (`padding_segments`; mask_queries=False keeps
    every query row, None masks them too when Sq == Sk, as the reference
    does). bias: optional additive mask broadcastable to
    [batch, heads, Sq, Sk], streamed chunkwise through the block-stats
    kernel (`flash_attention_biased`, kind "dense"). q and kv lengths may
    differ when not causal (the segment kernels run without ids).

    use_kernel=None routes by device (kernels on CUDA, the plain versions
    on CPU); True demands the kernels and raises ValueError for a CPU
    tensor or a shape/dtype they do not take."""
    if bias is not None:
        return flash_attention_biased(q, k, v, "dense", bias, causal=causal,
                                      scale=scale, padding_mask=padding_mask,
                                      use_kernel=use_kernel)
    seg_q = seg_kv = None
    if padding_mask is not None:
        seg_q, seg_kv = padding_segments(padding_mask.to(q.device),
                                         q.shape[1], k.shape[1],
                                         mask_queries)
    return _attend(q, k, v, seg_q, seg_kv, causal, scale, use_kernel)


# ------------------------------------------------------------- packed


def packed_supported(total_q, total_k, n_heads_q, n_heads_k, D) -> bool:
    """The packed route's gate (the reference's l.383): the kernels take
    any totals; D in {64, 128} and q heads a multiple of kv heads."""
    return (int(total_q) > 0 and int(total_k) > 0 and int(D) in (64, 128)
            and int(n_heads_k) > 0 and int(n_heads_q) % int(n_heads_k) == 0)


def flash_attention_packed(q, k, v, seg_q, seg_kv, causal=False,
                           scale=None, use_kernel=None):
    """Packed varlen attention: q [total_q, Hq, D] and k/v [total_k, Hk, D]
    holding many sequences back to back; seg_q / seg_kv int [total]
    sequence ids (1-based). The segment kernels at batch 1: attention
    across sequences is masked by segment, and global causal + segments
    is per-sequence causal when q and kv share the packing. The
    reference pads the totals to 128 with segment 0; the kernels mask
    their ragged edge instead, which changes no real row. Causal needs
    total_q == total_k."""
    out = _attend(q[None], k[None], v[None], seg_q.reshape(1, -1),
                  seg_kv.reshape(1, -1), causal, scale, use_kernel,
                  what="flash_attention_packed")
    return out[0]


# ------------------------------------------------------------- biased


def _bias_chunk(kind, params, Sq, s0, s1, causal, padding_mask):
    """The f32 bias of keys s0:s1 against all Sq queries, generated on
    the fly from `params`, as a 4-D tensor broadcastable to [B, H, Sq,
    s1 - s0] that keeps size 1 where it does not vary (alibi and
    rel_table are [1, H, Sq, lk], a [B, 1, 1, Sk] dense bias stays
    [B, 1, 1, lk]):

    - "alibi": params = slopes [H]; bias = -slope * (i - j), -slope |i - j|
      when not causal;
    - "rel_table": params = (table [H, 2R + 1], R); bias = table[h,
      clip(j - i, -R, R) + R];
    - "dense": params = an array broadcastable to [B, H, Sq, Sk], sliced.

    Causal (top-left, j <= i) and per-batch padding masks fold in as
    -1e30 entries, which the block-stats kernel zeroes exactly."""
    dev = (params[0] if kind == "rel_table" else params).device
    pos_q = torch.arange(Sq, device=dev)
    pos_k = torch.arange(s0, s1, device=dev)
    if kind == "alibi":
        slopes = params.float().reshape(-1)
        dist = (pos_q[:, None] - pos_k[None, :]).float()
        if not causal:
            dist = dist.abs()
        bias = (-slopes[:, None, None] * dist)[None]        # [1, H, lq, lk]
    elif kind == "rel_table":
        table, R = params
        idx = (pos_k[None, :] - pos_q[:, None]).clamp(-R, R) + R
        bias = table.float()[:, idx][None]                  # [1, H, lq, lk]
    elif kind == "dense":
        bias = params.float()
        while bias.dim() < 4:
            bias = bias[None]
        if bias.shape[3] != 1:
            bias = bias.narrow(3, s0, s1 - s0)
    else:
        raise ValueError(f"unknown bias kind {kind!r}")
    if causal:
        vis = pos_q[:, None] >= pos_k[None, :]
        bias = torch.where(vis, bias, torch.full_like(bias, _NEG))
    if padding_mask is not None:
        valid = padding_mask.bool()[:, None, None, s0:s1]
        bias = torch.where(valid, bias, torch.full((), _NEG,
                                                   device=bias.device))
    return bias


_BIAS_KINDS = {"alibi": 1, "rel_table": 2, "dense": 3}


def _chunks(Sk, chunk):
    """[(start, stop)] of the plain versions' KV chunks: `chunk` keys
    each (None = 512, the reference's default without an autotune entry;
    the port has no autotune), the last one shorter where Sk is not a
    multiple."""
    C = min(int(chunk or 512), Sk)
    return [(s, min(s + C, Sk)) for s in range(0, Sk, C)]


def _sum_to(t, shape):
    """t summed over the dims where `shape` broadcasts (size 1)."""
    for ax, n in enumerate(shape):
        if n == 1 and t.shape[ax] != 1:
            t = t.sum(dim=ax, keepdim=True)
    return t


def _kv_chunk(t, s0, s1, group):
    """Keys s0:s1 of k or v [B, Sk, Hk, D] as f32 [B, Hq, s1 - s0, D]
    (GQA: each kv head repeated for its group, this chunk only)."""
    c = t[:, s0:s1].transpose(1, 2).float()
    return c.repeat_interleave(group, dim=1) if group > 1 else c


def _biased_plain_fwd(q, k, v, kind, param, R, causal, scale,
                      padding_mask, chunk):
    """The bias kernels' forward in plain PyTorch, f32 over KV chunks
    with `_bias_chunk`: x = s * scale + bias, entries whose bias is <=
    -5e29 masked (P = 0), online softmax across chunks. Returns (o
    [B, Sq, Hq, D] in q's dtype, 0 on a row with no valid key; lse f32
    [B, Hq, Sq], +inf on such a row). Holds a few [B, Hq, Sq, chunk]
    buffers, never [B, Hq, Sq, Sk]."""
    B, Sq, Hq, D = q.shape
    Sk, group = k.shape[1], Hq // k.shape[2]
    pf = param.detach()
    qh = q.transpose(1, 2).float()
    m = torch.full((B, Hq, Sq, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, Hq, Sq, D), device=q.device)
    for s0, s1 in _chunks(Sk, chunk):
        bias_c = _bias_chunk(kind, pf if R is None else (pf, R), Sq, s0, s1,
                             causal, padding_mask)
        s = qh @ _kv_chunk(k, s0, s1, group).transpose(-1, -2)
        s.mul_(scale).add_(bias_c)
        s.masked_fill_(~(bias_c > 0.5 * _NEG), float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = s.sub_(m_use).exp_()
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p @ _kv_chunk(v, s0, s1, group)
        m = m_new
        del s, p, bias_c
    has = l > 0
    o = torch.where(has, o / torch.where(has, l, 1.0), 0.0)
    lse = torch.where(has, m + torch.log(l), float("inf"))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def _bwd_chunks(qh, k, v, doh, lse, kind, param, R, causal, scale,
                padding_mask, chunk, grad_param=False):
    """Per KV chunk of the biased backward, in f32 [B, Hq, Sq, c]: yields
    (s0, s1, kc, p, dp, bias_c, leaf) with kc the chunk's keys [B, Hq, c,
    D], p = exp(s * scale + bias - lse) (0 where masked; lse +inf on a
    row with no valid key gives 0), dp = dO V^T. With grad_param the
    chunk's bias is built under autograd from `leaf`, a fresh leaf of
    `param`. qh, doh: q and dO as f32 [B, Hq, Sq, D]; lse [B, Hq, Sq]."""
    Sq, Hq = qh.shape[2], qh.shape[1]
    group = Hq // k.shape[2]
    lse = lse[..., None]
    for s0, s1 in _chunks(k.shape[1], chunk):
        kc = _kv_chunk(k, s0, s1, group)
        with torch.enable_grad():
            leaf = param.detach().requires_grad_(grad_param)
            bias_c = _bias_chunk(kind, leaf if R is None else (leaf, R), Sq,
                                 s0, s1, causal, padding_mask)
        bc = bias_c.detach()
        p = qh @ kc.transpose(-1, -2)
        p.mul_(scale).add_(bc).sub_(lse).exp_()
        p.masked_fill_(~(bc > 0.5 * _NEG), 0.0)
        dp = doh @ _kv_chunk(v, s0, s1, group).transpose(-1, -2)
        yield s0, s1, kc, p, dp, bias_c, leaf


def _biased_plain_bwd(q, k, v, o, lse, do, kind, param, R, causal, scale,
                      padding_mask, chunk):
    """The bias kernels' backward in plain PyTorch over KV chunks: D =
    rowsum(dO * O) from the stored output, P recomputed from lse, dS = P
    (dP - D); dq = scale dS K, dk = scale dS^T Q and dv = P^T dO (summed
    over each kv head's group). Returns (dq, dk, dv) in the inputs'
    dtypes; dk and dv are written once per chunk."""
    group = q.shape[2] // k.shape[2]
    qh, doh = q.transpose(1, 2).float(), do.transpose(1, 2).float()
    delta = _delta(o, do)[..., None]
    dq = torch.zeros_like(qh)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for s0, s1, kc, p, dp, _, _ in _bwd_chunks(
            qh, k, v, doh, lse, kind, param, R, causal, scale, padding_mask,
            chunk):
        ds = dp.sub_(delta).mul_(p)
        dq.add_(ds @ kc, alpha=scale)
        dk[:, s0:s1] = (_group_sum(ds.transpose(-1, -2) @ qh, group)
                        * scale).transpose(1, 2)
        dv[:, s0:s1] = _group_sum(p.transpose(-1, -2) @ doh,
                                  group).transpose(1, 2)
        del p, ds, kc
    return dq.transpose(1, 2).to(q.dtype), dk, dv


def _biased_plain_dparam(q, k, v, o, lse, do, kind, param, R, causal,
                         scale, padding_mask, chunk):
    """The bias parameter's gradient (slopes, table or the dense bias):
    a plain chunked pass over the same P and dS as `_biased_plain_bwd`,
    each chunk's dS pulled back through `_bias_chunk` by autograd. There
    is no kernel for it, in the reference or here."""
    qh, doh = q.transpose(1, 2).float(), do.transpose(1, 2).float()
    delta = _delta(o, do)[..., None]
    dparam = None
    for _, _, _, p, dp, bias_c, leaf in _bwd_chunks(
            qh, k, v, doh, lse, kind, param, R, causal, scale, padding_mask,
            chunk, grad_param=True):
        ds = dp.sub_(delta).mul_(p)
        del p
        (g,) = torch.autograd.grad(bias_c, leaf, _sum_to(ds, bias_c.shape))
        dparam = g if dparam is None else dparam + g
    return dparam.to(param.dtype)


class _BiasArgs(NamedTuple):
    """The bias kernels' arguments: kind (1 alibi, 2 rel_table, 3 dense),
    p the f32 slopes [Hq], table [Hq, 2R + 1] or dense bias (read through
    `strides`, the element strides of [B, Hq, Sq, Sk], 0 where it
    broadcasts), R, and kv_valid the uint8 [B, Sk] padding mask or
    None."""
    kind: int
    p: torch.Tensor
    R: int
    strides: tuple
    kv_valid: Optional[torch.Tensor]


def _bias_args(kind, param, R, padding_mask, q_shape, k_shape):
    """Lower a bias to the kernels' arguments (`_BiasArgs`), moving no
    bias bytes for alibi and rel_table (one f32 row per head) and none
    for a dense bias already in f32 (a strided view of it)."""
    B, Sq, Hq, _ = (int(n) for n in q_shape)
    Sk = int(k_shape[1])
    if kind not in _BIAS_KINDS:
        raise ValueError(f"unknown bias kind {kind!r}")
    p = param.detach().float()
    strides = (0, 0, 0, 0)
    R = 0 if R is None else int(R)
    try:
        if kind == "alibi":
            p = p.reshape(-1).expand(Hq).contiguous()
        elif kind == "rel_table":
            p = p[..., :2 * R + 1].expand(Hq, 2 * R + 1).contiguous()
        else:
            p = p.reshape((1,) * (4 - p.dim()) + tuple(p.shape))
            p = p.expand(B, Hq, Sq, Sk)
            strides = tuple(p.stride())
    except RuntimeError as e:
        raise ValueError(f"flash_attention_biased: {kind} parameter "
                         f"{tuple(param.shape)} does not broadcast to "
                         f"q {tuple(q_shape)}, k {tuple(k_shape)}") from e
    kv_valid = None
    if padding_mask is not None:
        kv_valid = padding_mask.to(torch.uint8).expand(B, Sk).contiguous()
    return _BiasArgs(_BIAS_KINDS[kind], p, R, strides, kv_valid)


def _bias_kernel_takes(q, k, v):
    return (supported(q.shape, k.shape, True, has_bias=True, dtype=q.dtype)
            and k.shape == v.shape and k.dtype == v.dtype == q.dtype)


def _bias_launch(name, q, k, v, bias, causal, scale, ptrs):
    """Launch one bias entry: `ptrs` the entry's leading pointers, then
    the bias arguments, the shape, causal, scale and the stream."""
    if q.device.type != "cuda" or not _bias_kernel_takes(q, k, v):
        raise ValueError(
            f"{name}: the bias kernels do not take q {tuple(q.shape)} "
            f"{q.dtype} on {q.device}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} (need CUDA tensors of one bf16/f32 dtype, "
            f"equal batch, D in (64, 128), q heads a multiple of kv heads)")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    lib = _build.library()
    with torch.cuda.device(q.device):
        _build.check(_fn(lib, f"ptt_{name}", q.dtype)(
            *ptrs, bias.p.data_ptr(),
            None if bias.kv_valid is None else bias.kv_valid.data_ptr(),
            B, Sq, Sk, Hq, Hk, D, int(bool(causal)), bias.kind, bias.R,
            *bias.strides, float(scale), _stream(q)), name)


def flash_attention_bias_fwd(q, k, v, bias, causal, scale):
    """Kernel route, biased forward: q [B, Sq, Hq, D], k/v [B, Sk, Hk, D]
    (GQA read natively), `bias` from `_bias_args`, causal top-left for
    any Sq and Sk, `scale` on the f32 scores -> (o [B, Sq, Hq, D] in q's
    dtype, 0 on a row with no valid key; lse [B, Hq, Sq] f32, +inf on
    such a row). A tensor the kernel does not take raises ValueError."""
    B, Sq, Hq, D = q.shape
    q, k, v = (_rows(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    _bias_launch("flash_attention_bias_fwd", q, k, v, bias, causal, scale,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr()))
    flash_attention_bias_fwd.launches += 1
    return o, lse


def flash_attention_bias_dkv(q, k, v, do, lse, delta, bias, causal, scale):
    """Kernel route, biased backward dk and dv (one launch; dk and dv sum
    over each kv head's group of q heads in f32)."""
    q, k, v, do = (_rows(t) for t in (q, k, v, do))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _bias_launch("flash_attention_bias_dkv", q, k, v, bias, causal, scale,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr()))
    flash_attention_bias_dkv.launches += 1
    return dk, dv


def flash_attention_bias_dq(q, k, v, do, lse, delta, bias, causal, scale):
    """Kernel route, biased backward dq (one launch)."""
    q, k, v, do = (_rows(t) for t in (q, k, v, do))
    dq = torch.empty_like(q)
    _bias_launch("flash_attention_bias_dq", q, k, v, bias, causal, scale,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr()))
    flash_attention_bias_dq.launches += 1
    return dq


class _Biased(torch.autograd.Function):
    """flash_attention_biased. CUDA: one `flash_attention_bias_fwd`
    launch; the backward computes D = rowsum(dO * O) in plain PyTorch and
    launches `flash_attention_bias_dkv` and `flash_attention_bias_dq`.
    CPU, or `plain` on any device (`biased_plain`): `_biased_plain_fwd`
    and `_biased_plain_bwd`, the kernels' yardstick. The bias
    parameter's gradient, when asked for, is `_biased_plain_dparam` on
    both."""

    @staticmethod
    def forward(ctx, q, k, v, param, kind, R, causal, scale, padding_mask,
                chunk, plain):
        bias = None
        if plain:
            o, lse = _biased_plain_fwd(q, k, v, kind, param, R, causal,
                                       scale, padding_mask, chunk)
        else:
            bias = _bias_args(kind, param, R, padding_mask, q.shape,
                              k.shape)
            o, lse = flash_attention_bias_fwd(q, k, v, bias, causal, scale)
        ctx.save_for_backward(q, k, v, param, o, lse)
        ctx.cfg = (kind, R, causal, scale, padding_mask, chunk, bias)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, param, o, lse = ctx.saved_tensors
        kind, R, causal, scale, padding_mask, chunk, bias = ctx.cfg
        do = do.to(q.dtype)
        if bias is None:
            dq, dk, dv = _biased_plain_bwd(q, k, v, o, lse, do, kind, param,
                                           R, causal, scale, padding_mask,
                                           chunk)
        else:
            delta = _delta(o, do)
            args = (q, k, v, do, lse, delta, bias, causal, scale)
            dk, dv = flash_attention_bias_dkv(*args)
            dq = flash_attention_bias_dq(*args)
        dparam = None
        if ctx.needs_input_grad[3]:
            dparam = _biased_plain_dparam(q, k, v, o, lse, do, kind, param,
                                          R, causal, scale, padding_mask,
                                          chunk)
        return (dq, dk, dv, dparam, None, None, None, None, None, None,
                None)


def flash_attention_biased(q, k, v, kind, params, causal=False, scale=None,
                           padding_mask=None, chunk=None, use_kernel=None):
    """Blockwise-bias flash attention, BSHD in and out: the bias made or
    read inside the kernels ("alibi": params = slopes [H]; "rel_table":
    (table [H, 2R + 1], R); "dense": an array broadcastable to [B, H, Sq,
    Sk]; `_bias_chunk` states each), causal top-left for any Sq and Sk,
    a [B, Sk] padding mask, entries whose bias is <= -5e29 masked; output
    in q's dtype, 0 on a row with no valid key. GQA reads each kv head
    natively, scale multiplies the f32 scores. Differentiable in q, k, v
    and the bias parameters. `chunk` is the plain versions' KV chunk
    (None = 512); the kernels' kv tile is fixed, and the result does not
    depend on it. use_kernel=True demands the kernels (ValueError on a
    CPU tensor or a shape they do not take)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ok = _bias_kernel_takes(q, k, v)
    if use_kernel and (not ok or q.device.type == "cpu"):
        raise ValueError(
            f"flash_attention_biased: use_kernel=True but the bias kernels "
            f"do not take q {tuple(q.shape)} {q.dtype} on {q.device}, k "
            f"{tuple(k.shape)}")
    if q.device.type != "cpu" and not ok:
        raise ValueError(f"flash_attention_biased: no kernel for q "
                         f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}")
    if kind == "rel_table":
        param, R = params
        R = int(R)
    else:
        param, R = params, None
    if not torch.is_tensor(param):
        param = torch.as_tensor(param, device=q.device)
    elif param.device != q.device:
        param = param.to(q.device)
    if padding_mask is not None:
        padding_mask = padding_mask.to(q.device).bool()
    return _Biased.apply(q, k, v, param, kind, R, bool(causal), float(scale),
                         padding_mask, chunk, q.device.type == "cpu")


def biased_plain(q, k, v, kind, param, R=None, causal=False, scale=None,
                 padding_mask=None, chunk=None):
    """The bias route's plain versions on any device, differentiable in q,
    k, v and the bias parameter: what `flash_attention_biased` runs for
    a CPU tensor (param a tensor on q's device, R rel_table's radius,
    padding_mask bool [B, Sk] or None)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Biased.apply(q, k, v, param, kind, R, bool(causal), float(scale),
                         padding_mask, chunk, True)


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_delta.launches = 0
flash_attention_seg_fwd.launches = 0
flash_attention_seg_dkv.launches = 0
flash_attention_seg_dq.launches = 0
flash_attention_bias_fwd.launches = 0
flash_attention_bias_dkv.launches = 0
flash_attention_bias_dq.launches = 0
