"""Paged-KV decode attention — one query token per sequence over a paged
KV cache (counterpart of paddle_tpu/kernels/paged_attention.py; same
contract).

q [B, nh, d] holds each sequence's one decode token; the pool
k/v_pages [kvh, n_pages, page, d] holds the cached keys and values, and
sequence b reads its first lengths[b] tokens through the block table
page_indices[b, j // page]. GQA: kv head h serves q heads h*rep ..
(h+1)*rep - 1, rep = nh / kvh.

A CUDA tensor launches `csrc/paged_attention.cu`; a CPU tensor runs
`_dense_fallback`, the reference's fallback ported as written. Both
take q pre-scaled in q's own dtype (the reference's l.71: its kernel
applies no scale), and keep f32 from there on; the output is q's dtype.

The kernel is split-KV: each sequence's keys are cut into splits of
`_paged_split.SPLIT_KEYS` keys (whole pages), one block each, merged
exactly in split order (`_paged_split`; its scratch and tickets are kept
per device and stream); `_split_plain` runs the same schedule and merge in plain
PyTorch for the CPU tests.

The pool may be any strided view with unit stride along d: the kernel
takes the three outer strides, so `paginate_cache`'s views of a
contiguous [B, S, kvh, d] cache are read in place and nothing is
copied. A CUDA layout the kernel does not take raises; the wrapper never
copies the pool.

Zero lengths: the reference's fallback returns NaN there (a softmax over
nothing); the kernel returns zeros. No caller passes 0: every decode
step counts the token it just wrote.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build, _paged_split

__all__ = ["decode_attention", "paged_decode_attention", "paginate_cache",
           "supported"]

_PAGE = 16  # tokens per page of `decode_attention`'s views


def supported(q_shape, pages_shape, dtype=torch.bfloat16) -> bool:
    """q: [B, nh, d]; pages: [kvh, n_pages, page, d] — the kernel takes
    d in {64, 128}, nh % kvh == 0, bf16 or f32 (any page size)."""
    _, nh, d = (int(v) for v in q_shape)
    kvh, _, page, d2 = (int(v) for v in pages_shape)
    return (d == d2 and d in (64, 128) and page > 0 and kvh > 0
            and nh % kvh == 0 and dtype in (torch.bfloat16, torch.float32))


def _layout_ok(k_pages, v_pages) -> bool:
    """The kernel's 16-byte loads along d: unit stride on d, the same
    strides for k and v, outer strides (of dims longer than 1) whole
    vectors, both pools 16-byte aligned."""
    vec = 16 // k_pages.element_size()
    st = k_pages.stride()
    return (v_pages.stride() == st and st[3] == 1
            and all(s % vec == 0 for s, n in zip(st[:3], k_pages.shape[:3])
                    if n > 1)
            and k_pages.data_ptr() % 16 == 0
            and v_pages.data_ptr() % 16 == 0)


def paginate_cache(cache_k, cache_v, page_size=_PAGE):
    """[..., B, S_max, kvh, d] contiguous cache -> (k_pages, v_pages,
    page_indices): the pool layout [..., kvh, B*ppseq, page, d] as VIEWS
    of the cache (no copy; the reference's transpose), with the identity
    block table [B, ppseq] on the cache's device. A leading layer dim
    gives every layer's views at once: layer l's pool is k_pages[l]."""
    *lead, B, S, kvh, d = cache_k.shape
    if S % page_size:
        raise ValueError(f"S_max {S} must be a page multiple")
    ppseq = S // page_size

    def to_pages(c):
        return c.view(*lead, B * ppseq, page_size, kvh, d).movedim(-2, -4)

    page_indices = torch.arange(B * ppseq, dtype=torch.int32,
                                device=cache_k.device).view(B, ppseq)
    return to_pages(cache_k), to_pages(cache_v), page_indices


def _dense_fallback(q, k_pages, v_pages, lengths, page_indices):
    """The reference's fallback (q already scaled): gather each
    sequence's pages dense, mask past its length, one f32 softmax."""
    B, nh, d = q.shape
    kvh, _, page, _ = k_pages.shape
    ppseq = page_indices.shape[1]
    S = ppseq * page

    def gather(pages):                                     # -> [B, S, kvh, d]
        x = pages[:, page_indices.long()]       # [kvh, B, ppseq, page, d]
        x = torch.movedim(x, 0, 3)              # [B, ppseq, page, kvh, d]
        return x.reshape(B, S, kvh, d)

    k = gather(k_pages)
    v = gather(v_pages)
    rep = nh // kvh
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    # keys past the length are selected out of V, not weighted by p = 0:
    # a reused page may hold a non-finite value there
    v = torch.where(valid[:, :, None, None], v.float(), 0.0)
    o = torch.einsum("bhs,bshd->bhd", p, v)
    return o.to(q.dtype)


def _plain(q, k_pages, v_pages, lengths, page_indices, scale):
    """The CPU route for any device: pre-scale in q's dtype, then the
    dense fallback (chip_smoke.py's comparison route)."""
    return _dense_fallback(q * scale, k_pages, v_pages, lengths,
                           page_indices)


def _split_pages(page, ppseq):
    """Pages per split of the kernel's schedule: SPLIT_KEYS keys' worth,
    at least one page, and no more than MAX_SPLITS splits a sequence."""
    return _paged_split.split_keys(_paged_split.SPLIT_KEYS, ppseq * page,
                                   page) // page


def _heads_per_block(rep):
    """q heads one block serves (the kernel's G): every q head of a kv
    head, up to 8."""
    return 1 if rep <= 1 else 2 if rep <= 2 else 4 if rep <= 4 else 8


@functools.lru_cache(maxsize=256)
def _launch_plan(B, nh, kvh, page, ppseq, d, split_keys):
    """(pages per split, tickets, f32 scratch elements) of a launch,
    worked out once a shape: the wrapper runs every decode step of every
    layer."""
    sp = _paged_split.split_keys(split_keys, ppseq * page, page) // page
    rep = nh // kvh
    return (sp, B * kvh * -(-rep // _heads_per_block(rep)),
            _paged_split.scratch_floats(-(-ppseq // sp), B * nh, d))


def _split_plain(q, k_pages, v_pages, lengths, page_indices, scale):
    """The kernel's split schedule and merge in plain PyTorch, f32 math
    (`_paged_split.split_attention`): sequence b's keys [0, len) cut into
    splits of `_split_pages` pages, each q head's partial per split,
    merged in split order. For the CPU tests; the output is q's dtype."""
    B, nh, d = q.shape
    kvh, _, page, _ = k_pages.shape
    ppseq = page_indices.shape[1]
    S = ppseq * page

    def gather(pages):                                     # -> [B, S, nh, d]
        x = torch.movedim(pages[:, page_indices.long()], 0, 3)
        x = x.reshape(B, S, kvh, d).float()
        return torch.repeat_interleave(x, nh // kvh, dim=2)

    k, v = gather(k_pages), gather(v_pages)
    qs = (q * scale).float()
    s = torch.einsum("bhd,bshd->bhs", qs, k).reshape(B * nh, S)
    lens = lengths.to(q.device).long().clamp(0, S)
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    sk = _split_pages(page, ppseq) * page
    n_live = torch.clamp((lens + sk - 1) // sk, min=1)
    o = _paged_split.split_attention(
        s, v.permute(0, 2, 1, 3).reshape(B * nh, S, d),
        valid.repeat_interleave(nh, 0),
        torch.full((B * nh,), sk, device=q.device),
        n_live.repeat_interleave(nh))
    return o.reshape(B, nh, d).to(q.dtype)


def _launch(q, k_pages, v_pages, lengths, page_indices, scale):
    B, nh, d = q.shape
    kvh, _, page, _ = k_pages.shape
    ppseq = page_indices.shape[1]
    dev = q.device
    qc = q.contiguous()                 # [B, nh, d]: the query, not the pool
    if qc.data_ptr() % 16:
        raise ValueError("paged_decode_attention: q is not 16-byte aligned")
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    pidx = page_indices.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)
    sp, n_tickets, n_scratch = _launch_plan(B, nh, kvh, page, ppseq, d,
                                            _paged_split.SPLIT_KEYS)
    lib = _build.library()
    fn = (lib.ptt_paged_decode_attention_bf16 if q.dtype == torch.bfloat16
          else lib.ptt_paged_decode_attention_f32)
    s_head, s_page, s_tok, _ = k_pages.stride()
    with torch.cuda.device(dev):
        stream, tickets, part = _paged_split.buffers(dev, n_tickets,
                                                     n_scratch)
        _build.check(fn(qc.data_ptr(), k_pages.data_ptr(),
                        v_pages.data_ptr(), lens.data_ptr(), pidx.data_ptr(),
                        out.data_ptr(), part, tickets, B, nh, kvh, page,
                        ppseq, sp, d, s_head, s_page, s_tok, float(scale),
                        stream),
                     "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           scale=None, use_kernel=None):
    """One decode step over a paged cache.

    q: [B, nh, d]; k/v_pages: [kvh, total_pages, page, d] (any strides
    with unit stride on d on the card); lengths: i32[B] valid tokens per
    sequence; page_indices: i32[B, pages_per_seq]. Returns [B, nh, d] in
    q.dtype (f32 math).

    use_kernel=None routes by device (kernel on CUDA, plain on CPU);
    True demands the kernel and raises ValueError for a CPU tensor or a
    shape, dtype or layout the kernel does not take."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ok = (supported(q.shape, k_pages.shape, q.dtype)
          and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype
          and v_pages.shape == k_pages.shape
          and tuple(lengths.shape) == (q.shape[0],)
          and page_indices.dim() == 2
          and page_indices.shape[0] == q.shape[0])
    if use_kernel and not ok:
        raise ValueError(
            f"paged_decode_attention: use_kernel=True but the kernel does "
            f"not take q {tuple(q.shape)} {q.dtype}, pages "
            f"{tuple(k_pages.shape)} {k_pages.dtype} (need d in "
            f"{{64, 128}}, nh % kvh == 0, one bf16/f32 dtype, lengths "
            f"[B], page_indices [B, pages_per_seq])")
    if q.device.type == "cpu":
        if use_kernel:
            raise ValueError("paged_decode_attention: use_kernel=True "
                             "needs a CUDA tensor")
        return _plain(q, k_pages, v_pages, lengths, page_indices, scale)
    if not ok:
        raise ValueError(
            f"paged_decode_attention: no kernel for q {tuple(q.shape)} "
            f"{q.dtype}, pages {tuple(k_pages.shape)}")
    if not _layout_ok(k_pages, v_pages):
        raise ValueError(
            f"paged_decode_attention: the kernel does not take pool "
            f"strides {k_pages.stride()} / {v_pages.stride()} (need unit "
            f"stride on d, equal k/v strides, 16-byte vectors)")
    return _launch(q, k_pages, v_pages, lengths, page_indices, scale)


paged_decode_attention.launches = 0


def decode_attention(q, cache_k, cache_v, cur_len, scale=None):
    """Convenience: q [B, 1, nh, d] + contiguous cache [B, S_max, kvh, d]
    -> [B, 1, nh, d] through the paged kernel. The cache is read in
    place when S_max is a page multiple; otherwise it is padded (a copy,
    as in the reference). A caller looping over layers builds the views,
    block table and lengths once instead (`_forward_with_cache`)."""
    B = q.shape[0]
    S = cache_k.shape[1]
    pad = (-S) % _PAGE
    if pad:
        cache_k = torch.nn.functional.pad(cache_k, (0, 0, 0, 0, 0, pad))
        cache_v = torch.nn.functional.pad(cache_v, (0, 0, 0, 0, 0, pad))
    kp, vp, pidx = paginate_cache(cache_k, cache_v)
    lengths = torch.as_tensor(cur_len, dtype=torch.int32,
                              device=q.device).expand(B)
    out = paged_decode_attention(q[:, 0], kp, vp, lengths, pidx, scale=scale)
    return out[:, None]
