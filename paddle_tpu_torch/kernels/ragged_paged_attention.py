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

The kernel is split-KV (`_paged_split`, shared with the paged decode
kernel): per kv head, a sequence's rows with their rep q heads packed in
are cut into tiles (64-row tensor-core tiles in bf16 for a sequence of
more than 8 packed rows, else 8-row walk tiles), and each tile's keys
into splits of `_paged_split.SPLIT_KEYS` keys, merged exactly in split
order. A sequence flagged in `row_tiles` (the engine's decode and
speculative verify entries) is cut per local row instead: each row's rep
packed rows are tiled as a q_len = 1 sequence's, so every row of such an
entry computes bitwise what it would as a decode row. `_schedule`
mirrors the kernel's schedule and `_split_plain` runs it in plain
PyTorch for the CPU tests. The pool may be any strided view with unit
stride along d (the kernel takes its outer strides); it is never copied.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build, _paged_split
from .paged_attention import _layout_ok

__all__ = ["ragged_paged_attention", "supported"]

_PAGES = (8, 16, 32, 64)     # whole pages tile the kernel's 64-key tiles
_KT = 64                     # keys per K/V tile: splits are multiples
TILE_ROWS, WALK_ROWS = 64, 8


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
    # masked keys are selected out of V, not weighted by p = 0: a reused
    # page may hold a non-finite value past the sequence's length
    v = torch.where(mask[:, :, None, None], v.float(), 0.0)
    o = torch.einsum("ths,tshd->thd", p, v)
    # fully-masked rows (padding / idle slots) softmax to nan: drop them
    o = torch.where(valid_row[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def _split_keys(S):
    """Keys per split for a block table of S keys: SPLIT_KEYS in whole
    K/V tiles."""
    return _paged_split.split_keys(_paged_split.SPLIT_KEYS, S, _KT)


@functools.lru_cache(maxsize=256)
def _launch_plan(T, nh, kvh, d, B, S, bf16, split_keys, row_tiles):
    """(keys per split, tickets, f32 scratch elements) of a launch, worked
    out once a shape: the wrapper runs every serving step of every layer.
    Tickets: one a tile and kv head, with one walk tile per sequence of
    <= WALK_ROWS packed rows and ceil(rows / tile) for the rest, and with
    row tiles one more a local row."""
    sk = _paged_split.split_keys(split_keys, S, _KT)
    tiles = (-(-T * (nh // kvh) // (TILE_ROWS if bf16 else WALK_ROWS)) + B
             + (T if row_tiles else 0))
    return (sk, tiles * kvh,
            _paged_split.scratch_floats(-(-S // sk), T * nh, d))


def _schedule(q_len, kv_len, rep, S, tensor_tiles, row_tiles=None):
    """The kernel's tiles, per sequence: a list of (r0, r1, keys per
    split, kend, live splits) over its q_len * rep packed rows (packed
    row r = local row r // rep, head r % rep of the kv head). The rows
    are cut into groups: all of them, or each local row's rep where
    `row_tiles` flags the sequence. A group of more than WALK_ROWS
    packed rows takes TILE_ROWS-row tiles when `tensor_tiles` (bf16),
    else WALK_ROWS-row walk tiles; a tile's keys end at its last row's
    causal limit, cut to kv_len and to the table's S keys."""
    sk = _split_keys(S)
    own = ([False] * len(q_len) if row_tiles is None
           else [bool(x) for x in row_tiles.tolist()])
    out = []
    for ql, kl, rt in zip(q_len.tolist(), kv_len.tolist(), own):
        nrows = max(ql, 0) * rep
        gs = rep if rt else nrows
        rpt = TILE_ROWS if tensor_tiles and gs > WALK_ROWS else WALK_ROWS
        tiles = []
        for g0 in range(0, nrows, max(gs, 1)):
            for r0 in range(g0, g0 + gs, rpt):
                r1 = min(r0 + rpt, g0 + gs)
                kend = min(kl, S, kl - ql + (r1 - 1) // rep + 1)
                tiles.append((r0, r1, sk, kend,
                              1 if kend <= 0 else -(-kend // sk)))
        out.append(tiles)
    return out


def _split_plain(q, k_pages, v_pages, q_start, q_len, kv_len, page_table,
                 scale, tensor_tiles=None, row_tiles=None):
    """The kernel's schedule (`_schedule`; tensor_tiles defaults to q's
    dtype being bf16; `row_tiles` as the wrapper's) and merge in plain
    PyTorch, f32 math
    (`_paged_split.split_attention`): each row's keys up to its causal
    limit, cut into its tile's splits, merged in split order; rows of no
    sequence are zero. For the CPU tests; the output is q's dtype."""
    T, nh, d = q.shape
    kvh, _, page, _ = k_pages.shape
    B, ppmax = page_table.shape
    S = ppmax * page
    rep = nh // kvh
    if tensor_tiles is None:
        tensor_tiles = q.dtype == torch.bfloat16
    q_start, q_len, kv_len = (x.long().cpu() for x in (q_start, q_len,
                                                       kv_len))
    sched = _schedule(q_len, kv_len, rep, S, tensor_tiles,
                      None if row_tiles is None else row_tiles.cpu())
    # each (row, head): its sequence, its key limit and its tile's split
    sid = torch.zeros(T, nh, dtype=torch.long)
    kend = torch.zeros(T, nh, dtype=torch.long)
    sk = torch.ones(T, nh, dtype=torch.long)
    n_live = torch.ones(T, nh, dtype=torch.long)
    owned = torch.zeros(T, nh, dtype=torch.bool)
    for s, tiles in enumerate(sched):
        ql, kl, qs = int(q_len[s]), int(kv_len[s]), int(q_start[s])
        for r0, r1, sk_t, _, live in tiles:
            for r in range(r0, r1):
                i, g = divmod(r, rep)
                for kh in range(kvh):
                    t, h = qs + i, kh * rep + g
                    sid[t, h] = s
                    kend[t, h] = min(kl, S, kl - ql + i + 1)
                    sk[t, h], n_live[t, h] = sk_t, live
                    owned[t, h] = True

    def gather(pages):                            # -> [B, S, nh, d] f32
        x = torch.movedim(pages[:, page_table.long()], 0, 3)
        x = x.reshape(B, S, kvh, d).float()
        return torch.repeat_interleave(x, rep, dim=2)

    dev = q.device
    k, v = gather(k_pages), gather(v_pages)
    heads = torch.arange(nh)[None, :].expand(T, nh)
    kr = k[sid.to(dev), :, heads.to(dev)]         # [T, nh, S, d]
    vr = v[sid.to(dev), :, heads.to(dev)]
    s_ = torch.einsum("thd,thsd->ths", (q * scale).float(), kr)
    valid = ((torch.arange(S)[None, None, :] < kend[..., None])
             & owned[..., None])
    o = _paged_split.split_attention(
        s_.reshape(T * nh, S), vr.reshape(T * nh, S, d),
        valid.reshape(T * nh, S).to(dev), sk.reshape(-1).to(dev),
        n_live.reshape(-1).to(dev))
    o = torch.where(owned.reshape(-1, 1).to(dev), o, 0.0)
    return o.reshape(T, nh, d).to(q.dtype)


def _launch(q, k_pages, v_pages, q_start, q_len, kv_len, page_table, scale,
            row_tiles):
    T, nh, d = q.shape
    kvh, _, page, _ = k_pages.shape
    B, ppmax = page_table.shape
    dev = q.device
    qc = q.contiguous()                 # [T, nh, d]: the query, not the pool
    if qc.data_ptr() % 16:
        raise ValueError("ragged_paged_attention: q is not 16-byte aligned")
    meta = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (q_start, q_len, kv_len, page_table)]
    if row_tiles is not None:
        row_tiles = row_tiles.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)          # every row is written by the kernel
    bf16 = q.dtype == torch.bfloat16
    sk, n_tickets, n_scratch = _launch_plan(T, nh, kvh, d, B, ppmax * page,
                                            bf16, _paged_split.SPLIT_KEYS,
                                            row_tiles is not None)
    lib = _build.library()
    fn = (lib.ptt_ragged_paged_attention_bf16 if bf16
          else lib.ptt_ragged_paged_attention_f32)
    s_head, s_page, s_tok, _ = k_pages.stride()
    with torch.cuda.device(dev):
        stream, tickets, part = _paged_split.buffers(dev, n_tickets,
                                                     n_scratch)
        _build.check(fn(qc.data_ptr(), k_pages.data_ptr(),
                        v_pages.data_ptr(), *(m.data_ptr() for m in meta),
                        None if row_tiles is None else row_tiles.data_ptr(),
                        out.data_ptr(), part, tickets, T, nh, kvh, page, d, B,
                        ppmax, sk, s_head, s_page, s_tok, float(scale),
                        stream),
                     "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, q_start, q_len, kv_len,
                           page_table, scale=None, use_kernel=None,
                           row_tiles=None):
    """Packed ragged causal attention over the paged KV pool.

    q: [T, nh, d]; k/v_pages: [kvh, n_pages, page, d] (any strides with
    unit stride on d on the card); q_start/q_len/kv_len: i32[B];
    page_table: i32[B, ppmax]; row_tiles: None or bool/i32[B], the
    sequences whose rows each take tiles of their own on the card (every
    row bitwise what it gives as a q_len = 1 decode row; the CPU route
    computes each row alone in any case). Returns [T, nh, d] in q.dtype
    (f32 math).

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape, dtype or layout the kernel does not take."""
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
    if not _layout_ok(k_pages, v_pages):
        raise ValueError(
            f"ragged_paged_attention: the kernel does not take pool "
            f"strides {k_pages.stride()} / {v_pages.stride()} (need unit "
            f"stride on d, equal k/v strides, 16-byte vectors)")
    return _launch(q, k_pages, v_pages, q_start, q_len, kv_len, page_table,
                   scale, row_tiles)


ragged_paged_attention.launches = 0
