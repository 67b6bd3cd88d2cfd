"""The split-KV schedule and merge of the paged attention kernels
(csrc/paged_split.cuh), host side: the split size, the scratch and
tickets a launch needs, and the schedule's plain PyTorch emulation that
the CPU tests hold against the JAX package.

A row's keys [0, kend) are cut into splits of `sk` keys (SPLIT_KEYS,
a whole number of pages); a row group (the rows one block serves) with kend keys has
ceil(kend / sk) live splits, at least one. With one live split the block
writes o / l directly; otherwise each split leaves its partial (m, l, o
unnormalised, f32) and the last block to arrive merges them in split
order: out = sum_z o_z exp(m_z - M) / L, L = sum_z l_z exp(m_z - M).
"""
from __future__ import annotations

import torch

__all__ = ["MAX_SPLITS", "SPLIT_KEYS", "split_keys", "scratch_floats",
           "buffers", "split_attention"]

MAX_SPLITS = 32   # csrc/paged_split.cuh's ptt::paged::MAX_SPLITS
# keys per split of both kernels (rounded to whole pages, and for the
# ragged kernel to whole 64-key tiles): chosen on the H100 by
# chip_smoke.py's sweep at the bucketed engine's decode, generate's cache
# and the serving step's mixed and decode-only rows (PERF.md, PR 13)
SPLIT_KEYS = 256

_buffers = {}


def split_keys(want, S, unit):
    """Keys per split: `want` rounded down to a multiple of `unit` (at
    least one unit), raised until S keys need at most MAX_SPLITS
    splits."""
    sk = max(unit, want // unit * unit)
    least = -(-S // MAX_SPLITS)
    return max(sk, -(-least // unit) * unit)


def scratch_floats(n_split, R, d):
    """f32 elements of the partials of n_split splits of R rows of d
    (csrc/paged_split.cuh::part_o_offset's layout: (m, l), then o from a
    16-byte boundary); 0 when one split is all a row can have."""
    if n_split <= 1:
        return 0
    return (2 * n_split * R + 3) // 4 * 4 + n_split * R * d


def buffers(device, n_tickets, n_scratch, stream=None):
    """(stream, tickets, scratch) pointers for a launch on `device`'s
    current stream (or the raw `stream` the caller already read):
    at least n_tickets int32 tickets, zero between
    launches (the last block of each group resets its ticket, so they are
    zeroed once, when made or grown), and n_scratch f32 elements of
    scratch from torch.empty (0: none, a null pointer). Both are kept per
    device and stream and reused by every launch on that stream, whose
    kernels run one after another."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    tk, part = _buffers.get(key, (None, None))
    if tk is None or tk.numel() < n_tickets:
        grown = max(n_tickets, 2 * (0 if tk is None else tk.numel()))
        tk = torch.zeros(grown, dtype=torch.int32, device=device)
    if n_scratch and (part is None or part.numel() < n_scratch):
        part = torch.empty(n_scratch, dtype=torch.float32, device=device)
    _buffers[key] = (tk, part)
    return stream, tk.data_ptr(), part.data_ptr() if n_scratch else None


def split_attention(s, v, valid, sk, n_live):
    """The kernels' split schedule and merge on f32 rows, in plain
    PyTorch. s: [R, S] scores; v: [R, S, d] values; valid: [R, S] bool;
    sk, n_live: [R] keys per split and live splits of each row's group.
    Split z of a row holds its valid keys in [z * sk, z * sk + sk) for
    z < n_live; its partial is (m_z, l_z, o_z), and a split with no valid
    key of the row is (-inf, 0, 0). Returns [R, d]: o_0 / l_0 where
    n_live is 1, else the merge in split order (zeros for a row with no
    valid key)."""
    S = s.shape[-1]
    # invalid keys are selected out of V (the kernels never load them):
    # a weight of 0 times a stale non-finite value would be NaN
    v = torch.where(valid[..., None], v, 0.0)
    key = torch.arange(S, device=s.device)
    zkey = key[None, :] // sk[:, None]
    ms, ls, os_ = [], [], []
    for z in range(int(n_live.max())):
        in_z = valid & (zkey == z) & (z < n_live)[:, None]
        sz = s.masked_fill(~in_z, float("-inf"))
        m = sz.amax(-1)
        p = torch.exp(sz - torch.where(torch.isinf(m), 0.0, m)[:, None])
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append(torch.einsum("rs,rsd->rd", p, v))
    m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os_)
    M = m.amax(0)
    c = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
    L = (l * c).sum(0)
    w = torch.where((L > 0)[None], c / torch.where(L > 0, L, 1.0)[None], 0.0)
    merged = (w[..., None] * o).sum(0)
    # l == 0 (no valid key) gives zeros; a NaN l stays NaN, as the kernels'
    direct = torch.where((l[0] == 0)[:, None], 0.0,
                         o[0] / torch.where(l[0] == 0, 1.0, l[0])[:, None])
    return torch.where((n_live == 1)[:, None], direct, merged)
