"""Ragged paged attention — packed prefill-chunk and decode rows in ONE
kernel launch over the paged KV pool (counterpart of
paddle_tpu/kernels/ragged_paged_attention.py; same contract).

q [T, nh, d] holds every sequence's rows back to back; per-sequence
i32[B] metadata (q_start, q_len, kv_len) says which rows belong to
sequence s and how many KV tokens it holds after this step's keys were
written. Row t of sequence s sits at absolute position
kv_len[s] - q_len[s] + (t - q_start[s]) and attends causally through
the block table page_table i32[B, ppmax] into the shared
[kvh, n_pages, page, d] pool (page 0 is the engine's scratch page).
Rows belonging to no sequence, and idle slots (q_len == 0), return zero.

A CUDA tensor launches `csrc/ragged_paged_attention.cu`; a CPU tensor
runs `_dense_fallback`, the reference's exact fallback ported as
written (q pre-scaled in q's dtype, -inf masking, softmax before the
value contraction).
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "supported"]

_PAGES = (8, 16, 32, 64)     # whole pages tile the kernel's 64-key tiles


def supported(q_shape, pages_shape, dtype=torch.bfloat16) -> bool:
    """q: [T, nh, d]; pages: [kvh, n_pages, page, d] — the kernel takes
    d in {64, 128}, page in {8, 16, 32, 64}, nh % kvh == 0, bf16 or
    f32."""
    T, nh, d = (int(v) for v in q_shape)
    kvh, _, page, d2 = (int(v) for v in pages_shape)
    return (d == d2 and d in (64, 128) and page in _PAGES
            and kvh > 0 and nh % kvh == 0
            and dtype in (torch.bfloat16, torch.float32))


def _size_class(total_q: int) -> int:
    """Quantize the packed row count to a power of two (>= 8): the
    engine's one fixed padded row count."""
    c = 8
    while c < total_q:
        c *= 2
    return c


def _row_ids(T, q_start, q_len):
    """For each packed row t: (sequence id, local index within the
    sequence, membership bool)."""
    t = torch.arange(T, device=q_start.device)
    member = ((t[:, None] >= q_start[None, :])
              & (t[:, None] < (q_start + q_len)[None, :]))
    sid = torch.argmax(member.to(torch.int32), dim=1)
    valid = member.any(dim=1)
    local = t - q_start[sid]
    return sid, local, valid


def _dense_fallback(q, k_pages, v_pages, q_start, q_len, kv_len,
                    page_table, scale):
    """Gather each row's sequence KV dense, one causal softmax per row.
    Memory is O(T * pages_per_seq * page)."""
    T, nh, d = q.shape
    kvh, _, page, _ = k_pages.shape
    B, ppmax = page_table.shape
    S = ppmax * page
    q_start, q_len, kv_len = (x.long() for x in (q_start, q_len, kv_len))
    sid, local, valid_row = _row_ids(T, q_start, q_len)
    pos = kv_len[sid] - q_len[sid] + local                 # abs position
    q = q * scale                                          # pre-scale, q dtype

    def gather(pages):                                     # -> [B, S, kvh, d]
        x = pages[:, page_table.long()]         # [kvh, B, ppmax, page, d]
        x = torch.movedim(x, 0, 3)              # [B, ppmax, page, kvh, d]
        return x.reshape(B, S, kvh, d)

    k = gather(k_pages)[sid]                               # [T, S, kvh, d]
    v = gather(v_pages)[sid]
    rep = nh // kvh
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("thd,tshd->ths", q.float(), k.float())
    kv_pos = torch.arange(S, device=q.device)
    mask = ((kv_pos[None, :] <= pos[:, None])
            & (kv_pos[None, :] < kv_len[sid][:, None])
            & valid_row[:, None])
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("ths,tshd->thd", p, v.float())
    # fully-masked rows (padding / idle slots) softmax to nan: drop them
    o = torch.where(valid_row[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def _launch(q, k_pages, v_pages, q_start, q_len, kv_len, page_table, scale):
    T, nh, d = q.shape
    kvh, n_pages, page, _ = k_pages.shape
    B, ppmax = page_table.shape
    dev = q.device
    qc = q.contiguous()
    kp = k_pages.contiguous()
    vp = v_pages.contiguous()
    for t, name in ((qc, "q"), (kp, "k_pages"), (vp, "v_pages")):
        if t.data_ptr() % 16:
            raise ValueError(f"ragged_paged_attention: {name} is not "
                             f"16-byte aligned")
    meta = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (q_start, q_len, kv_len, page_table)]
    out = torch.zeros_like(qc)          # rows no block writes stay zero
    lib = _build.library()
    fn = (lib.ptt_ragged_paged_attention_bf16 if q.dtype == torch.bfloat16
          else lib.ptt_ragged_paged_attention_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        *(m.data_ptr() for m in meta), out.data_ptr(),
                        T, nh, kvh, n_pages, page, d, B, ppmax,
                        float(scale), stream),
                     "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, q_start, q_len, kv_len,
                           page_table, scale=None, use_kernel=None):
    """Packed ragged causal attention over the paged KV pool.

    q: [T, nh, d]; k/v_pages: [kvh, n_pages, page, d];
    q_start/q_len/kv_len: i32[B]; page_table: i32[B, ppmax]. Returns
    [T, nh, d] in q.dtype (f32 math).

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape/dtype the kernel does not take."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ok = (supported(q.shape, k_pages.shape, q.dtype)
          and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype
          and v_pages.shape == k_pages.shape)
    if use_kernel and not ok:
        raise ValueError(
            f"ragged_paged_attention: use_kernel=True but the kernel does "
            f"not take q {tuple(q.shape)} {q.dtype}, pages "
            f"{tuple(k_pages.shape)} {k_pages.dtype} (need d in "
            f"{{64, 128}}, page in {_PAGES}, nh % kvh == 0, one "
            f"bf16/f32 dtype)")
    if q.device.type == "cpu":
        if use_kernel:
            raise ValueError("ragged_paged_attention: use_kernel=True "
                             "needs a CUDA tensor")
        return _dense_fallback(q, k_pages, v_pages, q_start, q_len, kv_len,
                               page_table, scale)
    if not ok:
        raise ValueError(
            f"ragged_paged_attention: no kernel for q {tuple(q.shape)} "
            f"{q.dtype}, pages {tuple(k_pages.shape)}")
    return _launch(q, k_pages, v_pages, q_start, q_len, kv_len, page_table,
                   scale)


ragged_paged_attention.launches = 0
