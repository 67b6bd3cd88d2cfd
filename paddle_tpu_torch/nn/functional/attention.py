"""Attention functionals (counterpart of
paddle_tpu/nn/functional/attention.py): `scaled_dot_product_attention`,
`flash_attention`, `flash_attn_unpadded` and the `sdp_kernel` shim, on
`torch.Tensor`s in paddle's [batch, seq, heads, head_dim] layout.

`scaled_dot_product_attention` takes the reference's three routes
(attention.py:94-127), each through `kernels/flash_attention.py`:
no mask; a boolean mask that varies only along the keys (`_as_padding_
mask`) as a padding mask, lowered to segment ids; any other mask
broadcastable to [B, H, Sq, Sk] as an additive bias through the chunked
block-stats route (a boolean one becomes 0 / -1e30). The reference takes
its dense `_sdpa_ref` on the CPU and the kernels on the TPU; the port
runs the kernels' functions on both devices (their plain versions on
the CPU). A padding mask masks the keys alone (`mask_queries=False`),
as `_sdpa_ref` does, so every row agrees with it: the reference's TPU
lowering also masks the query rows when Sq == Sk, which in a
cross-attention at equal lengths would drop a valid target row whose
index is a padded source position. `flash_attn_unpadded` is the packed
route with 1-based segment ids from cu_seqlens (`_packed_segments`).

With `dropout_p > 0`, sdpa (and `flash_attention`) takes the
reference's dense route on both devices, as the reference takes it on
every device (l.129-136): `_sdpa_ref`, then in training `F.dropout` on
the output. `flash_attn_unpadded` takes the reference's dense packed
route (`_unpadded_dense`, l.196-231) in its two cases: with `dropout >
0` in training (it applies no dropout, as the reference's applies
none), and causal over q and kv packings that differ (each key's
position in its own sequence at most the query's).

`sparse_attention` (l.249-300) turns the CSR pattern into a [B, H, S, S]
bool mask once, with the key padding and attention masks folded in, and
runs the reference's masked f32 softmax (`_masked_attention_core`, the
port's copy of paddle_tpu/sparse/__init__.py:318-330): no kernel, as
the reference has none.
"""
from __future__ import annotations

import math

import torch

from ...kernels import flash_attention as fa
from .common import dropout as _dropout

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sdp_kernel", "sparse_attention"]


def _sdpa_ref(q, k, v, mask, dropout_p, causal, scale):
    """The reference's dense route, [B, S, H, D], f32 inside: a boolean
    mask drops entries (-inf), a float mask adds. No dropout (sdpa
    applies it to the output). sdpa takes it when dropout_p > 0, as the
    reference does; without dropout the kernels' functions run on both
    devices, and the tests hold them to this route."""
    del dropout_p
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril(
            sk - sq)
        s = s.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            s = s.masked_fill(~mask, float("-inf"))
        else:
            s = s + mask.float()
    p = torch.softmax(s, dim=-1)
    return (p @ vt).transpose(1, 2).to(q.dtype)


def _as_padding_mask(mask, batch, kv_len):
    """A keep/drop mask that provably varies only along the kv axis as a
    [B, kv_len] validity mask; None when not convertible. Convertible:
    BOOLEAN masks shaped [kv], [B, kv], [B, 1, kv] or [B, 1, 1, kv]; an
    additive float mask may carry finite biases that segment ids cannot
    represent, so it never converts."""
    if mask.dtype != torch.bool:
        return None
    shape = tuple(mask.shape)
    if shape not in ((kv_len,), (batch, kv_len), (batch, 1, kv_len),
                     (batch, 1, 1, kv_len)):
        return None
    flat = mask.reshape(shape[0] if len(shape) > 1 else 1, kv_len)
    if len(shape) == 1:
        flat = flat.expand(batch, kv_len)
    return flat


def _bias_broadcastable(mask_shape, q_shape, k_shape) -> bool:
    """mask broadcastable to [B, H, Sq, Sk] (numpy rules, trailing dims)."""
    target = (q_shape[0], q_shape[2], q_shape[1], k_shape[1])
    if len(mask_shape) > 4:
        return False
    return all(got in (1, want) for got, want in zip(reversed(mask_shape),
                                                    reversed(target)))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Layout [batch, seq, heads, head_dim] (paddle's flash_attn
    convention), scale 1/sqrt(head_dim). Returns the output in query's
    dtype."""
    del name
    q, k, v = query, key, value
    scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_p > 0.0:
        mask = None if attn_mask is None else attn_mask.to(q.device)
        out = _sdpa_ref(q, k, v, mask, dropout_p, is_causal, scale)
        if training:
            out = _dropout(out, p=dropout_p, training=True)
        return out
    if attn_mask is None:
        return fa.flash_attention_bshd(q, k, v, causal=is_causal,
                                       scale=scale)
    mask = attn_mask.to(q.device)
    pad = _as_padding_mask(mask, q.shape[0], k.shape[1])
    if pad is not None:
        # a mask of the keys alone, as the reference's dense route reads
        # it: every query row is kept (its TPU route also drops the
        # queries at Sq == Sk, which breaks cross-attention there)
        return fa.flash_attention_bshd(q, k, v, causal=is_causal,
                                       scale=scale, padding_mask=pad,
                                       mask_queries=False)
    if not _bias_broadcastable(tuple(mask.shape), q.shape, k.shape):
        raise ValueError(
            f"scaled_dot_product_attention: attn_mask {tuple(mask.shape)} "
            f"does not broadcast to [B, H, Sq, Sk] = [{q.shape[0]}, "
            f"{q.shape[2]}, {q.shape[1]}, {k.shape[1]}]")
    bias = (torch.where(mask, 0.0, -1e30).float()
            if mask.dtype == torch.bool else mask)
    return fa.flash_attention_bshd(q, k, v, causal=is_causal, scale=scale,
                                   bias=bias)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """paddle's `flash_attention`: (out, None); the softmax is never
    returned, as in the reference."""
    del return_softmax, fixed_seed_offset, rng_name, name
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def _packed_segments(cu, total):
    """cu_seqlens [n + 1] -> per-token segment ids [total], 1-BASED, so
    the kernels' padding (segment 0) never matches a real sequence."""
    cu = torch.as_tensor(cu).long().reshape(-1)
    idx = cu[1:-1]
    idx = idx[idx < total]
    marks = torch.zeros(total, dtype=torch.int32, device=cu.device)
    marks.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.cumsum(marks, 0, dtype=torch.int32) + 1


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over PACKED sequences: q [total_q, Hq, D], k/v
    [total_k, Hk, D], cu_seqlens the sequences' offsets. The packed
    segment kernels at batch 1 with 1-based segment ids; with dropout > 0
    in training, or causal over q and kv packings that differ, the
    reference's dense packed route (`_unpadded_dense`, no dropout
    applied). Returns (out, None)."""
    del max_seqlen_q, max_seqlen_k, return_softmax, fixed_seed_offset
    del rng_name, name
    q, k, v = query, key, value
    cq = torch.as_tensor(cu_seqlens_q)
    ck = torch.as_tensor(cu_seqlens_k)
    same = (cu_seqlens_q is cu_seqlens_k
            or torch.equal(cq.cpu(), ck.cpu()))
    cq, ck = cq.to(q.device), ck.to(q.device)
    if (dropout > 0.0 and training) or (causal and not same):
        return _unpadded_dense(q, k, v, cq, ck, causal, scale), None
    seg_q = _packed_segments(cq, q.shape[0])
    seg_kv = _packed_segments(ck, k.shape[0])
    out = fa.flash_attention_packed(q, k, v, seg_q, seg_kv, causal=causal,
                                    scale=scale)
    return out, None


def _unpadded_dense(q, k, v, cq, ck, causal, scale):
    """The reference's dense packed route (attention.py:208-228): f32
    scores over every (q, kv) token pair, kept where the 0-based
    sequence ids agree (and, causal, where the key's position in its
    sequence is at most the query's), softmax, a row with no kept key
    zeroed; kv heads repeated for GQA."""
    if q.shape[1] != k.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    cq, ck = cq.long().reshape(-1), ck.long().reshape(-1)
    seg_q = _packed_segments(cq, q.shape[0]).long() - 1
    seg_k = _packed_segments(ck, k.shape[0]).long() - 1
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    valid = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(q.shape[0], device=q.device) - cq[seg_q]
        pos_k = torch.arange(k.shape[0], device=q.device) - ck[seg_k]
        valid = valid & (pos_k[None, :] <= pos_q[:, None])
    s = torch.where(valid[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)


def _masked_attention_core(q, k, v, mask):
    """softmax(q k^T / sqrt(D)) over the keys `mask` [B, H, S, S] keeps,
    in f32, then @ v; a row with no kept key gives 0 (q, k, v [B, H, S,
    D])."""
    s = torch.einsum("bhsd,bhtd->bhst", q.float(),
                     k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.where(mask, s, float("-inf")), dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention restricted to a CSR pattern: q, k, v [B, H, S, D];
    offset [B, H, S + 1] and columns [B, H, nnz] list the keys each
    query row attends; key_padding_mask [B, S] and attn_mask [S, S] (or
    [B, H, S, S]) keep where nonzero."""
    del name
    q, k, v = query, key, value
    B, H, S, _ = q.shape
    off = torch.as_tensor(sparse_csr_offset, device=q.device).long()
    off = off.reshape(B * H, S + 1)
    cols = torch.as_tensor(sparse_csr_columns,
                           device=q.device).long().reshape(-1)
    counts = (off[:, 1:] - off[:, :-1]).reshape(-1)
    rows = torch.arange(B * H * S, device=q.device).repeat_interleave(counts)
    mask = torch.zeros(B * H * S * S, dtype=torch.bool, device=q.device)
    mask[rows * S + cols] = True
    mask = mask.reshape(B, H, S, S)
    if key_padding_mask is not None:
        mask = mask & (key_padding_mask.to(q.device)[:, None, None, :] != 0)
    if attn_mask is not None:
        mask = mask & (attn_mask.to(q.device) != 0)
    return _masked_attention_core(q, k, v, mask)


class sdp_kernel:
    """Context selecting attention backends (the reference's no-op
    torch-compat shim)."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
