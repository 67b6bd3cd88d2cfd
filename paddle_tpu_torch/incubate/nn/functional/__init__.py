"""incubate.nn.functional — the fused-op surface (counterpart of
paddle_tpu/incubate/nn/functional/__init__.py, function for function,
same names, arguments and float order).

Where the reference reaches a Pallas kernel the port reaches its
hand-written kernel: `fused_rms_norm` row 1 (`kernels.rms_norm`), the
attention of `fused_multi_head_attention` and
`variable_length_memory_efficient_attention` row 10
(`kernels.flash_attention`), `masked_multihead_attention` and
`block_multihead_attention` row 13 (`kernels.paged_attention`), and every
int8 product (`weight_only_linear`, `llm_int8_linear` and the (int8,
scale) weight pairs of `fused_multi_transformer`) the W8A16 kernel
(`kernels.weight_only_linear`, which the reference leaves to XLA's
fusion). Everything else is plain PyTorch, as the reference's is plain
jnp. CPU tensors take each kernel's plain version.

Differences from the reference, by design: the KV writes of
`masked_multihead_attention`, `block_multihead_attention` and
`fused_multi_transformer` are index writes into the caller's cache
tensors, which are returned (the reference builds new arrays: a one-hot
blend or `.at[].set`, equal on finite values); dropout masks come from
the port's dropout stream (`nn.functional.common._keep_mask` on
`framework.core.dropout_generator`), not from `jax.random`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ....kernels import flash_attention as kfa
from ....kernels import paged_attention as kpa
from ....kernels import rms_norm as krn
from ....kernels import rope as krope
from ....kernels import weight_only_linear as kwol
from ....nn.functional import common as _common

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "fused_bias_act", "swiglu", "masked_multihead_attention",
    "block_multihead_attention", "weight_quantize", "weight_dequantize",
    "weight_only_linear", "llm_int8_linear", "apply_per_channel_scale",
    "fused_linear", "fused_gemm_epilogue", "fused_linear_activation",
    "fused_multi_transformer", "fused_matmul_bias", "fused_dropout_add",
    "fused_bias_dropout_residual_layer_norm", "fused_multi_head_attention",
    "fused_feedforward", "fused_ec_moe",
    "variable_length_memory_efficient_attention", "blha_get_max_len"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _gelu(x):
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"gelu": _gelu, "relu": F.relu, "silu": F.silu}


def _act(name):
    if name not in _ACTS:
        raise ValueError(f"unsupported activation {name!r}")
    return _ACTS[name]


def _ln(v, g, b, eps):
    """The reference layer's layer norm (incubate/nn/layer.py::_ln): f32
    mean and mean of squared deviations, cast back to v's dtype."""
    vf = v.float()
    mu = vf.mean(-1, keepdim=True)
    var = ((vf - mu) ** 2).mean(-1, keepdim=True)
    out = (vf - mu) * torch.rsqrt(var + eps)
    if g is not None:
        out = out * g.float()
    if b is not None:
        out = out + b.float()
    return out.to(v.dtype)


# ------------------------------------------------------------------ norms

def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    """RMSNorm over the axes from `begin_norm_axis` on (row 1's kernel;
    several axes are flattened into one row, as the reference does),
    then + norm_bias."""
    nd = x.dim()
    bna = begin_norm_axis % nd if begin_norm_axis != -1 else nd - 1
    if bna == nd - 1:
        out = krn.rms_norm(x, norm_weight, epsilon)
    else:
        shp = x.shape
        flat = x.reshape(*shp[:bna], -1)
        out = krn.rms_norm(flat, norm_weight.reshape(-1),
                           epsilon).reshape(shp)
    if norm_bias is not None:
        out = out + norm_bias
    return out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5, **kw):
    """LayerNorm over the last axis (the reference's F.layer_norm: f32
    mean and variance)."""
    return _ln(x, norm_weight, norm_bias, epsilon)


# ------------------------------------------------------------------- rope

def _rotate_interleaved(a32):
    """GPT-J pair rotation: (x0, x1) -> (-x1, x0), interleaved back."""
    x1, x2 = a32[..., 0::2], a32[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(a32.shape)


def _gptj_sincos(pos, D, base=10000.0):
    """Interleaved-style tables: sin/cos of shape pos.shape + (D,) with
    each frequency repeated for its pair."""
    inv = 1.0 / (base ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=pos.device) / D))
    ang = pos.float()[..., None] * inv
    s = torch.repeat_interleave(ang, 2, dim=-1)
    return torch.sin(s), torch.cos(s)


def _rotate_half_f32(a32):
    h = a32.shape[-1] // 2
    return torch.cat([-a32[..., h:], a32[..., :h]], dim=-1)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotary embedding of q and k ([B, S, H, D]); v passes through.
    Explicit sin/cos caches ([S, D], or broadcastable 4-D) are honoured,
    gathered at `position_ids` [B, S] when given; neox (rotate-half) or
    GPT-J interleaved pairs. Without caches the neox style is the
    port's `kernels.rope.apply_rope`, plain PyTorch as the reference's
    rope is jnp."""
    if sin is not None and cos is not None:
        def rot(a):
            s32, c32 = sin.float(), cos.float()
            if position_ids is not None:
                idx = position_ids.long()
                s32 = s32.reshape(-1, s32.shape[-1])[idx][:, :, None, :]
                c32 = c32.reshape(-1, c32.shape[-1])[idx][:, :, None, :]
            elif s32.dim() == 2:
                s32 = s32[None, :, None, :]
                c32 = c32[None, :, None, :]
            a32 = a.float()
            r = (_rotate_half_f32(a32) if use_neox_rotary_style
                 else _rotate_interleaved(a32))
            return (a32 * c32 + r * s32).to(a.dtype)

        return rot(q), (rot(k) if k is not None else None), v
    if not use_neox_rotary_style:
        def rot_j(a):
            a32 = a.float()
            pos = (position_ids.float() if position_ids is not None
                   else torch.arange(a32.shape[1], dtype=torch.float32,
                                     device=a.device))
            if pos.dim() == 1:
                pos = pos[None]
            s, c = _gptj_sincos(pos, a32.shape[-1])
            s, c = s[:, :, None, :], c[:, :, None, :]
            return (a32 * c + _rotate_interleaved(a32) * s).to(a.dtype)

        return rot_j(q), (rot_j(k) if k is not None else None), v
    if k is not None:
        qo, ko = krope.apply_rope(q, k, position_ids=position_ids)
        return qo, ko, v
    return krope.apply_rope(q, q, position_ids=position_ids)[0], None, v


# ------------------------------------------------------------ activations

def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """act(x + bias); "swiglu" splits the last axis: silu(first half) *
    second half."""
    if act_method not in ("gelu", "relu", "silu", "swiglu"):
        raise ValueError(f"unsupported act_method {act_method!r}")
    a = x if bias is None else x + bias
    if act_method == "swiglu":
        u, g = torch.chunk(a, 2, dim=-1)
        return F.silu(u) * g
    return _act(act_method)(a)


def swiglu(x, y=None):
    """silu(x) * y, or with y None silu(first half) * second half of x."""
    if y is not None:
        return F.silu(x) * y
    u, g = torch.chunk(x, 2, dim=-1)
    return F.silu(u) * g


# ------------------------------------------------------- decode attention

def masked_multihead_attention(x, cache_kv=None, src_mask=None, *,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, out_smooth=None, seq_len=1,
                               rotary_emb_dims=0, use_neox_rotary_style=False,
                               compute_dtype="default", **kw):
    """One decode token of attention over a contiguous cache.

    x: this step's packed qkv [B, 3 * nh * d]; cache_kv: [2, B, nh,
    S_max, d]; sequence_lengths: tokens already cached [B]. The new k/v
    are written at position sequence_lengths[b] by an index write into
    cache_kv itself (the reference blends a one-hot row into a new
    array: the same values for finite caches). With src_mask (an
    additive [B, 1, 1, S] mask over the cached positions) the dense f32
    route, else row 13's kernel over the cache read in place (the
    reference's `decode_attention`). Rotary at the step's absolute position: neox (rotate-half)
    or GPT-J pairs. Returns (out [B, nh * d], cache_kv)."""
    if sequence_lengths is None:
        raise ValueError("sequence_lengths (tokens already cached) required")
    _, B, nh, S_max, d = cache_kv.shape
    qkv = x.reshape(B, 3, nh, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    sl = sequence_lengths.to(device=x.device, dtype=torch.int32).reshape(B)
    if rotary_emb_dims and rotary_emb_dims > 0:
        if use_neox_rotary_style:
            qr, kr = krope.apply_rope(q[:, None], k[:, None],
                                      position_ids=sl[:, None],
                                      seq_len=S_max)
            q, k = qr[:, 0], kr[:, 0]
        else:
            s, c = _gptj_sincos(sl, q.shape[-1])
            s, c = s[:, None, :], c[:, None, :]
            q32, k32 = q.float(), k.float()
            q = (q32 * c + _rotate_interleaved(q32) * s).to(q.dtype)
            k = (k32 * c + _rotate_interleaved(k32) * s).to(k.dtype)
    b = torch.arange(B, device=x.device)
    pos = sl.long()
    cache_kv[0][b, :, pos] = k.to(cache_kv.dtype)
    cache_kv[1][b, :, pos] = v.to(cache_kv.dtype)
    ck, cv = cache_kv[0], cache_kv[1]
    if src_mask is not None:
        sm = src_mask.float()
        if sm.dim() >= 3 and any(s != 1 for s in sm.shape[1:-1]):
            raise ValueError(
                "masked_multihead_attention src_mask must broadcast over "
                f"heads and the single query ([B, 1, 1, S]); got "
                f"{tuple(sm.shape)}")
        sm = sm.reshape(B, 1, -1)
        if sm.shape[-1] < S_max:
            sm = F.pad(sm, (0, S_max - sm.shape[-1]))
        sm = sm[..., :S_max]
        scores = torch.einsum("bhd,bhsd->bhs", q.float(),
                              ck.float()) / (d ** 0.5)
        pos_ok = (torch.arange(S_max, device=x.device)[None, None, :]
                  <= sl[:, None, None])
        scores = torch.where(pos_ok, scores + sm, -1e30)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhs,bhsd->bhd", p,
                           cv.float())[:, None].to(q.dtype)
    else:
        kp, vp, idx = _head_major_pages(ck, cv)
        out = kpa.paged_decode_attention(q, kp, vp, sl + 1, idx)[:, None]
    return out[:, 0].reshape(B, nh * d), cache_kv


def _head_major_pages(ck, cv):
    """A [B, nh, S, d] cache as row 13's pool [nh, pages, page, d] and
    its block table, in place: page j of sequence b is pool page b * nh
    * pp + j at head stride S * d (pages of 16 tokens when S is a
    multiple, else one page of S)."""
    ck, cv = ck.contiguous(), cv.contiguous()
    B, nh, S, d = ck.shape
    page = 16 if S % 16 == 0 else S
    pp = S // page
    size = (nh, (B - 1) * nh * pp + pp, page, d)
    stride = (S * d, page * d, d, 1)
    idx = (torch.arange(B, device=ck.device)[:, None] * nh * pp
           + torch.arange(pp, device=ck.device)[None, :]).to(torch.int32)
    return ck.as_strided(size, stride), cv.as_strided(size, stride), idx


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets=None, cum_offsets=None,
                              cu_seqlens_q=None, cu_seqlens_k=None,
                              block_tables=None, *, max_seq_len=None,
                              block_size=16, use_neox_style=False, **kw):
    """One decode token per sequence over paged ("block") KV pools.

    qkv: [B, (nh + 2 kvh) * d] packed heads (q heads, then k, then v:
    GQA splits by the pools' kvh); key/value_cache: [num_pages, kvh,
    block_size, d]; block_tables: [B, pages_per_seq]; seq_lens_decoder:
    tokens already cached [B]. The new token is written into its page
    slot in the caller's pools (an index write), then row 13's kernel
    reads the pools in place through a [kvh, pages, block, d] view.
    Returns (out [B, nh * d], key_cache, value_cache)."""
    bt = block_tables.to(device=qkv.device, dtype=torch.int32)
    sl = seq_lens_decoder.to(device=qkv.device,
                             dtype=torch.int32).reshape(-1)
    n_pages, kvh, bs, d = key_cache.shape
    B = bt.shape[0]
    total_heads = qkv.reshape(B, -1, d).shape[1]
    nh = total_heads - 2 * kvh
    heads = qkv.reshape(B, total_heads, d)
    q = heads[:, :nh]
    k = heads[:, nh:nh + kvh]
    v = heads[:, nh + kvh:]
    b = torch.arange(B, device=qkv.device)
    page_of = bt[b, (sl // bs).long()].long()
    slot_of = (sl % bs).long()
    key_cache[page_of, :, slot_of] = k.to(key_cache.dtype)
    value_cache[page_of, :, slot_of] = v.to(value_cache.dtype)
    out = kpa.paged_decode_attention(q, key_cache.movedim(1, 0),
                                     value_cache.movedim(1, 0), sl + 1, bt)
    return out.reshape(B, -1), key_cache, value_cache


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size,
                     name=None):
    """(max encoder length, max decoder length)."""
    return torch.max(seq_lens_encoder), torch.max(seq_lens_decoder)


# ------------------------------------------------------------ weight-only

def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """x [K, N] -> (codes int8 [K, N], f32 scales [N], or [K / g, N] with
    group_size g): absmax / qmax (127; 7 for weight_only_int4) floored at
    1e-8, codes rounded half to even and clipped to [-qmax - 1, qmax]."""
    wf = x.float()
    qmax = 7.0 if algo == "weight_only_int4" else 127.0
    if group_size and group_size > 0:
        K, N = wf.shape
        if K % group_size:
            raise ValueError(f"group_size {group_size} must divide K={K}")
        g = wf.reshape(K // group_size, group_size, N)
        scale = torch.clamp_min(torch.amax(torch.abs(g), dim=1) / qmax, 1e-8)
        q = torch.clamp(torch.round(g / scale[:, None, :]),
                        -qmax - 1, qmax).reshape(K, N)
        return q.to(torch.int8), scale
    scale = torch.clamp_min(torch.amax(torch.abs(wf), dim=0) / qmax, 1e-8)
    q = torch.clamp(torch.round(wf / scale[None, :]), -qmax - 1, qmax)
    return q.to(torch.int8), scale


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float16", group_size=-1):
    """The weight back in `out_dtype`: f32 codes times f32 scales (a
    group scale [K / g, N] over its g rows), rounded once."""
    dt = _DTYPES[out_dtype] if isinstance(out_dtype, str) else out_dtype
    if scale.dim() == 2:
        gs = x.shape[0] // scale.shape[0]
        out = (x.reshape(scale.shape[0], gs, -1).float()
               * scale[:, None, :].float()).reshape(x.shape)
    else:
        out = x.float() * scale[None, :]
    return out.to(dt)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x @ deq(weight) + bias on the W8A16 kernel (plain on the CPU),
    dequantized in the reference's order: codes and scale each cast to
    x's dtype, then multiplied. The scale is rounded to x's dtype here;
    an int8 code times a bf16 or f16 scale is exact in f32, so the
    kernel's one rounding of that f32 product gives the same value.
    Per-column [N] or group-wise [K / g, N] scales."""
    return kwol.weight_only_linear(x, weight,
                                   weight_scale.to(x.dtype).float(),
                                   bias=bias)


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0):
    """The reference lowers LLM.int8()'s outlier decomposition to
    `weight_only_linear`; so does the port."""
    return weight_only_linear(x, weight, bias, weight_scale)


def apply_per_channel_scale(x, scales):
    """x * scales over the last axis (smooth-quant pre-scaling)."""
    return x * scales.to(x.dtype)[None, :]


# ---------------------------------------------------------- GEMM epilogue

def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias): a plain product, as the reference leaves it
    to XLA."""
    return fused_linear_activation(x, weight, bias, trans_y=transpose_weight,
                                   activation="none", name=name)


fused_gemm_epilogue = fused_linear


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """act(op(x) @ op(y) + bias), act in gelu (tanh), relu, none."""
    acts = {"gelu": _gelu, "relu": F.relu, "none": lambda a: a,
            "": lambda a: a}
    if activation not in acts:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    a = x.transpose(-1, -2) if trans_x else x
    w = y.transpose(-1, -2) if trans_y else y
    out = a @ w
    if bias is not None:
        out = out + bias
    return acts[activation](out)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """op(x) @ op(y) + bias."""
    return fused_linear_activation(x, y, bias, trans_x=transpose_x,
                                   trans_y=transpose_y, activation="none",
                                   name=name)


# ---------------------------------------------------------------- dropout

def _dropout_mode(x, rate, training, mode):
    """Paddle's two dropout conventions on the port's dropout stream:
    upscale_in_train (kept elements / (1 - p) in training, identity at
    inference) and downscale_in_infer (kept as they are in training,
    x * (1 - p) at inference)."""
    if mode == "downscale_in_infer":
        if not training:
            return x * (1.0 - rate)
        if rate <= 0.0:
            return x
        keep = _common._keep_mask(x.shape, rate, None, x.device)
        return torch.where(keep, x, 0.0).to(x.dtype)
    if not training or rate <= 0.0:
        return x
    keep = _common._keep_mask(x.shape, rate, None, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y."""
    return _dropout_mode(x, p, training, mode) + y


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """LN(residual + dropout(x + bias))."""
    h = x if bias is None else x + bias
    return _ln(residual + _dropout_mode(h, dropout_rate, training, mode),
               ln_scale, ln_bias, ln_epsilon)


# -------------------------------------------------------------- attention

def _dense_attention(q, k, v, mask, dropout, out_dtype):
    """The reference's dense route over [B, S, H, D]: f32 scores scaled
    by 1/sqrt(D), + mask, softmax, `dropout` on the probabilities."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float()) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + mask.float()
    p = dropout(torch.softmax(s, dim=-1))
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(out_dtype)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None, cache_kv=None,
        attn_mask=None, dropout_rate=0.5, attn_dropout_rate=0.5,
        ln_epsilon=1e-5, training=True, mode="upscale_in_train", ring_id=-1,
        add_residual=True, num_heads=-1, transpose_qkv_wb=False, name=None):
    """Self-attention with a packed qkv weight [3, nh, d, H] (or [H, 3H]
    with transpose_qkv_wb and num_heads), pre- or post-LN, the residual
    and dropout epilogue. The attention runs row 10's flash kernels
    (autograd through their Function) when there is no mask and no
    probability dropout and the shapes are the kernels', else the
    reference's dense f32 route."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention cache_kv: use "
            "incubate.nn.functional.masked_multihead_attention for the "
            "cached decode step (paged-KV kernel path)")
    B, S, H = x.shape
    if transpose_qkv_wb:
        nh = int(num_heads)
        if nh <= 0:
            raise ValueError("num_heads required with transpose_qkv_wb")
        d = H // nh
        w2 = qkv_weight
    else:
        _, nh, d, _ = qkv_weight.shape
        w2 = qkv_weight.reshape(3 * nh * d, H).transpose(0, 1)
    residual = x
    a = _ln(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon) \
        if pre_layer_norm else x
    qkv = a @ w2
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(-1)
    qkv = qkv.reshape(B, S, 3, nh, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    no_drop = (not training) or attn_dropout_rate <= 0.0
    if attn_mask is None and no_drop and kfa.supported(
            q.shape, k.shape, True, dtype=q.dtype):
        o = kfa.flash_attention_bshd(q, k, v, causal=False)
    else:
        o = _dense_attention(
            q, k, v, attn_mask,
            lambda p: _dropout_mode(p, attn_dropout_rate, training, mode),
            x.dtype)
    out = o.reshape(B, S, H) @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    out = _dropout_mode(out, dropout_rate, training, mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _ln(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias=None,
        linear2_bias=None, ln1_scale=None, ln1_bias=None, ln2_scale=None,
        ln2_bias=None, dropout1_rate=0.5, dropout2_rate=0.5,
        activation="relu", ln1_epsilon=1e-5, ln2_epsilon=1e-5,
        pre_layer_norm=False, training=True, mode="upscale_in_train",
        ring_id=-1, add_residual=True, name=None):
    """residual + dropout2(linear2(dropout1(act(linear1(LN? x))))), the
    LN before (pre_layer_norm) or after."""
    if activation not in ("relu", "gelu"):
        raise ValueError(f"unsupported activation {activation!r}")
    act = _act(activation)
    residual = x
    a = _ln(x, ln1_scale, ln1_bias, ln1_epsilon) if pre_layer_norm else x
    h = a @ linear1_weight
    if linear1_bias is not None:
        h = h + linear1_bias
    h = _dropout_mode(act(h), dropout1_rate, training, mode)
    out = h @ linear2_weight
    if linear2_bias is not None:
        out = out + linear2_bias
    out = _dropout_mode(out, dropout2_rate, training, mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _ln(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu", name=None):
    """Expert-choice MoE over the caller's gate logits [B, S, E]: each
    expert takes its top T // E tokens by softmax probability, runs its
    MLP ([e, d, f], [e, f, d]) and the outputs, weighted by those
    probabilities, are summed back per token."""
    if act_type not in ("gelu", "relu"):
        raise ValueError(f"unsupported act_type {act_type!r}")
    act = _act(act_type)
    B, S, H = x.shape
    E = gate.shape[-1]
    T = B * S
    flat = x.reshape(T, H)
    scores = torch.softmax(gate.reshape(T, E).float(), dim=-1)
    cap = max(T // E, 1)
    probs, idx = torch.topk(scores.transpose(0, 1), cap, dim=-1)
    tok = flat[idx.reshape(-1)].reshape(E, cap, H)
    hmid = act(torch.einsum("ech,ehm->ecm", tok, bmm0_weight)
               + bmm0_bias.reshape(E, 1, -1))
    out = (torch.einsum("ecm,emh->ech", hmid, bmm1_weight)
           + bmm1_bias.reshape(E, 1, -1))
    out = out * probs[..., None].to(out.dtype)
    flat_out = torch.zeros((T, H), dtype=out.dtype, device=x.device)
    flat_out = flat_out.index_add(0, idx.reshape(-1), out.reshape(E * cap, H))
    return flat_out.reshape(B, S, H).to(x.dtype)


def variable_length_memory_efficient_attention(
        query, key, value, seq_lens, kv_seq_lens, mask=None, scale=None,
        causal=False, pre_cache_length=0, name=None):
    """Attention over [B, nh, S, D] with per-sequence lengths: key j of
    sequence b is valid below kv_seq_lens[b] + pre_cache_length. With no
    mask and not causal, row 10's segment kernels take the lengths as a
    padding mask; else the reference's dense f32 route (causal,
    additive mask). Query rows at or past seq_lens[b] are zero."""
    B, nh, Sq, D = query.shape
    Sk = key.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    ql = seq_lens.to(query.device).reshape(B)
    kl = kv_seq_lens.to(query.device).reshape(B) + int(pre_cache_length)
    ar_k = torch.arange(Sk, device=query.device)
    if mask is None and not causal and kfa.supported(
            (B, Sq, nh, D), (B, Sk, key.shape[1], D), True,
            dtype=query.dtype):
        pm = ar_k[None, :] < kl[:, None]
        o = kfa.flash_attention_bshd(
            query.transpose(1, 2), key.transpose(1, 2),
            value.transpose(1, 2), causal=False, scale=sc, padding_mask=pm)
        o = o.transpose(1, 2)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", query.float(), key.float()) * sc
        valid = (ar_k[None, :] < kl[:, None])[:, None, None]
        if causal:
            cm = (ar_k[None, :]
                  <= torch.arange(Sq, device=query.device)[:, None])
            valid = valid & cm[None, None]
        s = torch.where(valid, s, -1e30)
        if mask is not None:
            s = s + mask.float()
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, value.float())
    qvalid = (torch.arange(Sq, device=query.device)[None, :]
              < ql[:, None])[:, None, :, None]
    return torch.where(qvalid, o, 0.0).to(query.dtype)


# ------------------------------------------------------ multi-transformer

def _weight(t):
    """A weight of fused_multi_transformer in its stored layout: a
    tensor, or an (int8, scale) pair as a `QuantWeight`."""
    if isinstance(t, tuple) and len(t) == 2:
        return kwol.QuantWeight(t[0], t[1])
    return t


def _kn_scale(s, q_shape, to_kn):
    """The scale of an int8 weight stored as `q_shape`, broadcast and
    mapped like the weight to its [K, N] operand, as one value or one
    per column; None when it varies along K."""
    if s.numel() == 1:
        return s.reshape(1)
    skn = to_kn(torch.broadcast_to(s, q_shape))
    if skn.stride(0) != 0 and skn.shape[0] != 1:
        return None
    return skn[0].contiguous()


def _project(a, w, to_kn, swiglu_gu=False):
    """a @ to_kn(weight), then with `swiglu_gu` silu(gate half) * up
    half. A `QuantWeight` on the card runs the W8A16 kernel (its SwiGLU
    epilogue for `swiglu_gu`); on the CPU it is dequantized in the
    reference's order (f32 codes times the scale, rounded once) in its
    stored layout first."""
    if isinstance(w, kwol.QuantWeight):
        q, s = w
        if a.device.type != "cpu":
            skn = _kn_scale(s, q.shape, to_kn)
            if skn is None:
                raise ValueError(
                    f"fused_multi_transformer: an int8 weight "
                    f"{tuple(q.shape)} with scale {tuple(s.shape)} varies "
                    f"along its input axis; the W8A16 kernel takes one "
                    f"scale per output column")
            return kwol.weight_only_linear(a, to_kn(q), skn,
                                           swiglu=swiglu_gu)
        w = (q.float() * s.float()).to(a.dtype)
    out = a @ to_kn(w)
    if swiglu_gu:
        m = out.shape[-1] // 2
        return F.silu(out[..., :m]) * out[..., m:]
    return out


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-5, cache_kvs=None, pre_caches=None, seq_lens=None,
        rotary_embs=None, rotary_emb_dims=0, time_step=None, attn_mask=None,
        dropout_rate=0.0, activation="gelu", training=False,
        mode="upscale_in_train", trans_qkvw=True, ring_id=-1, name=None):
    """L transformer layers in one call, with optional KV caches for
    decode (the reference's l.457-656, op for op).

    x: [B, S, H]; qkv_weights[i]: [3, nh, d, H] with trans_qkvw, else
    [H, 3, nh, d]; caches: [2, B, nh, S_max, d] per layer, written in
    place by index writes (prefill: rows 0..S; decode, `time_step` set:
    each row's position, per sequence with `seq_lens`) and returned.
    Any qkv / linear / ffn1 / ffn2 weight may be an (int8, scale) pair
    (the serving PTQ layout); its product runs on the W8A16 kernel, the
    SwiGLU activation (no ffn1 bias) on the kernel's SwiGLU epilogue.
    Attention is the reference's dense f32 softmax (it has no kernel
    there). Returns out, or (out, caches) with caches."""
    B, S, Hdim = x.shape
    L = len(qkv_weights)
    if activation not in ("gelu", "relu", "swiglu"):
        raise ValueError(f"unsupported activation {activation!r}")
    decode = time_step is not None
    ts = ts_vec = None
    if decode:
        ts = int(torch.as_tensor(time_step).reshape(-1)[0])
        if seq_lens is not None:
            ts_vec = seq_lens.to(device=x.device,
                                 dtype=torch.int32).reshape(B)
    rot_cos = rot_sin = None
    if rotary_embs is not None:
        rot_cos = rotary_embs[0].reshape(-1, rotary_embs.shape[-1])
        rot_sin = rotary_embs[1].reshape(-1, rotary_embs.shape[-1])

    def norm(v, g, b):
        return _ln(v, g, b, epsilon)

    def pick(lst, i):
        return lst[i] if lst else None

    new_caches = []
    h = x
    dt = x.dtype
    for i in range(L):
        qkw = _weight(qkv_weights[i])
        if trans_qkvw:                      # [3, nh, d, H] -> [H, 3*nh*d]
            _, nh, d, _ = qkw.shape

            def qkv_kn(t, nh=nh, d=d):
                return t.reshape(3 * nh * d, Hdim).transpose(0, 1)
        else:
            nh = qkw.shape[2] if len(qkw.shape) == 4 else qkw.shape[1]
            d = qkw.shape[-1]

            def qkv_kn(t):
                return t.reshape(Hdim, -1)
        residual = h
        a = norm(h, ln_scales[i], pick(ln_biases, i)) if pre_layer_norm \
            else h
        qkv = _project(a, qkw, qkv_kn)
        if qkv_biases and qkv_biases[i] is not None:
            qkv = qkv + qkv_biases[i].reshape(-1)
        qkv = qkv.reshape(B, S, 3, nh, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if rotary_emb_dims and rotary_emb_dims > 0:
            pos = None
            if decode:
                base = (ts_vec if ts_vec is not None else torch.full(
                    (B,), ts, dtype=torch.int32, device=x.device))
                pos = base[:, None] + torch.arange(S, device=x.device)[None]
            if rot_cos is not None:
                pp = (pos if pos is not None else torch.arange(
                    S, device=x.device)[None].expand(B, S)).long()
                c = rot_cos[pp][:, :, None, :].float()
                sn = rot_sin[pp][:, :, None, :].float()

                def rot(t):
                    tf = t.float()
                    return (tf * c + _rotate_half_f32(tf) * sn).to(t.dtype)

                q, k = rot(q), rot(k)
            else:
                q, k = krope.apply_rope(
                    q, k, position_ids=pos,
                    seq_len=(cache_kvs[i].shape[3] if cache_kvs is not None
                             else S))
        mask_len = None
        if cache_kvs is not None:
            cache = cache_kvs[i]
            if decode:
                wpos = (ts_vec if ts_vec is not None else torch.full(
                    (B,), ts, dtype=torch.int32, device=x.device)).long()
                bi = torch.arange(B, device=x.device)
                cache[0][bi, :, wpos] = k[:, 0].to(cache.dtype)
                cache[1][bi, :, wpos] = v[:, 0].to(cache.dtype)
                k_use = cache[0].transpose(1, 2)
                v_use = cache[1].transpose(1, 2)
                mask_len = (wpos + 1)[:, None]
            else:
                cache[0][:, :, :S] = k.transpose(1, 2).to(cache.dtype)
                cache[1][:, :, :S] = v.transpose(1, 2).to(cache.dtype)
                k_use, v_use = k, v
            new_caches.append(cache)
        else:
            k_use, v_use = k, v
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k_use.float()) / math.sqrt(d)
        if decode and cache_kvs is not None:
            valid = (torch.arange(k_use.shape[1], device=x.device)[None, :]
                     < mask_len)
            s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        elif attn_mask is not None:
            s = s + attn_mask.float()
        else:
            cm = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=x.device))
            s = s.masked_fill(~cm[None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v_use.float()).to(dt)
        o = o.reshape(B, S, nh * d)
        lw = _weight(linear_weights[i])
        o = _project(o, lw, (lambda t: t) if lw.shape[0] == nh * d
                     else (lambda t: t.transpose(0, 1)))
        if linear_biases and linear_biases[i] is not None:
            o = o + linear_biases[i]
        if dropout_rate:
            o = _dropout_mode(o, dropout_rate, training, mode).to(o.dtype)
        h = residual + o
        if not pre_layer_norm:
            h = norm(h, ln_scales[i], pick(ln_biases, i))
        residual = h
        a = norm(h, ffn_ln_scales[i], pick(ffn_ln_biases, i)) \
            if pre_layer_norm else h
        f1w = _weight(ffn1_weights[i])
        f1_kn = ((lambda t: t) if f1w.shape[0] == Hdim
                 else (lambda t: t.transpose(0, 1)))
        f1b = ffn1_biases[i] if ffn1_biases else None
        if activation == "swiglu" and f1b is None:
            u = _project(a, f1w, f1_kn, swiglu_gu=True)
        else:
            u = _project(a, f1w, f1_kn)
            if f1b is not None:
                u = u + f1b
            if activation == "swiglu":
                g, ug = torch.chunk(u, 2, dim=-1)
                u = F.silu(g) * ug
            else:
                u = _act(activation)(u)
        f2w = _weight(ffn2_weights[i])
        u = _project(u, f2w, (lambda t: t) if f2w.shape[0] == u.shape[-1]
                     else (lambda t: t.transpose(0, 1)))
        if ffn2_biases and ffn2_biases[i] is not None:
            u = u + ffn2_biases[i]
        if dropout_rate:
            u = _dropout_mode(u, dropout_rate, training, mode).to(u.dtype)
        h = residual + u
        if not pre_layer_norm:
            h = norm(h, ffn_ln_scales[i], pick(ffn_ln_biases, i))
    if cache_kvs is None:
        return h
    return h, new_caches
