"""The split-KV schedule and merge of the port's paged attention kernels
(csrc/paged_split.cuh) against the JAX package, on the CPU: each
module's plain emulation of its kernel's schedule (`_split_plain`: the
partial (m, l, o) of every split, then the merge in split order) on
seeded numpy inputs, held against the JAX package's
`paged_decode_attention` and `ragged_paged_attention` (their fallbacks,
and for two layouts the ragged Pallas kernel in interpret mode) at atol
1e-5 in f32. The splits are set small so that every case cuts its keys
into several; the CUDA kernels themselves are held against the plain
versions by tests/test_torch_cuda.py and chip_smoke.py on the card."""
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as j_pa
from paddle_tpu.kernels import ragged_paged_attention as j_rpa
from paddle_tpu_torch import testing
from paddle_tpu_torch.kernels import _paged_split
from paddle_tpu_torch.kernels import paged_attention as t_pa
from paddle_tpu_torch.kernels import ragged_paged_attention as t_rpa

from _torch_threads import one_torch_thread  # noqa: F401,E402

ATOL = 1e-5
LAYOUTS = [(8, 2, 64, 8), (4, 4, 128, 16), (8, 2, 128, 16), (4, 4, 64, 8)]
LAYOUT_IDS = ["gqa_8_2_d64_p8", "mha_d128_p16", "gqa_8_2_d128_p16",
              "mha_d64_p8"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _edge_lengths(split, page, end):
    """1, page - 1, page, split, split + 1, 2 * split, the table's end."""
    return [1, page - 1, page, split, split + 1, 2 * split, end]


def _pool(rng, kvh, n_pages, page, d):
    return (rng.randn(kvh, n_pages, page, d).astype(np.float32),
            rng.randn(kvh, n_pages, page, d).astype(np.float32))


def _table(rng, lengths, ppseq, page, n_pages):
    """Each sequence owns ceil(length / page) distinct shuffled pages
    (page 0 unused)."""
    perm = rng.permutation(n_pages - 1) + 1
    pt = np.zeros((len(lengths), ppseq), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        used = -(-n // page)
        pt[b, :used] = perm[nxt:nxt + used]
        nxt += used
    return pt


# ------------------------------------------------ paged decode (row 13)

def _decode_case(nh, kvh, d, page, seed=0):
    """Sequences at the edges of the wrapper's split (whole pages), a
    table of 16 pages."""
    rng = np.random.RandomState(seed)
    ppseq = 16
    split = t_pa._split_pages(page, ppseq) * page
    lengths = _edge_lengths(split, page, ppseq * page)
    B = len(lengths)
    n_pages = B * ppseq + 1
    q = rng.randn(B, nh, d).astype(np.float32)
    kp, vp = _pool(rng, kvh, n_pages, page, d)
    pt = _table(rng, lengths, ppseq, page, n_pages)
    return q, kp, vp, np.asarray(lengths, np.int32), pt


@pytest.fixture
def small_splits(monkeypatch):
    """SPLIT_KEYS = 32: 32-key splits for paged decode; the ragged kernel
    rounds it up to one 64-key K/V tile."""
    monkeypatch.setattr(_paged_split, "SPLIT_KEYS", 32)


@pytest.mark.parametrize("nh,kvh,d,page", LAYOUTS + [(4, 2, 64, 12)],
                         ids=LAYOUT_IDS + ["gqa_4_2_d64_p12"])
def test_decode_split_plain_matches_jax(nh, kvh, d, page, small_splits):
    """The kernel's split schedule and merge (SPLIT_KEYS = 32: 4 pages of
    8, 2 of 16, 2 of 12 (24 keys)) at lengths 1, page - 1, page, split,
    split + 1, 2 x split and the block table's end, against the JAX
    package; any page size, 12 among them."""
    case = _decode_case(nh, kvh, d, page)
    assert t_pa._split_pages(page, case[4].shape[1]) == 32 // page
    want = np.asarray(j_pa.paged_decode_attention(
        *(jnp.asarray(x) for x in case)))
    scale = 1.0 / math.sqrt(d)
    got = t_pa._split_plain(*(_t(x) for x in case), scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nh,kvh,d,page", LAYOUTS[:2], ids=LAYOUT_IDS[:2])
def test_decode_split_plain_matches_wrapper_at_default_split(nh, kvh, d,
                                                             page):
    """At the wrapper's own SPLIT_KEYS, on a table long enough for
    several splits, the emulation agrees with the wrapper's CPU route."""
    rng = np.random.RandomState(1)
    ppseq = 4 * _paged_split.SPLIT_KEYS // page
    lengths = _edge_lengths(_paged_split.SPLIT_KEYS, page, ppseq * page)
    n_pages = len(lengths) * ppseq + 1
    q = _t(rng.randn(len(lengths), nh, d).astype(np.float32))
    kp, vp = (_t(x) for x in _pool(rng, kvh, n_pages, page, d))
    pt = _t(_table(rng, lengths, ppseq, page, n_pages))
    lens = _t(np.asarray(lengths, np.int32))
    scale = 1.0 / math.sqrt(d)
    got = t_pa._split_plain(q, kp, vp, lens, pt, scale)
    want = t_pa.paged_decode_attention(q, kp, vp, lens, pt, scale=scale)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_decode_split_zero_length_is_zero(small_splits):
    """A sequence of length 0 gives zeros (the kernel's contract; the
    reference's fallback returns NaN there)."""
    q, kp, vp, lens, pt = _decode_case(4, 4, 64, 8)
    lens = lens.copy()
    lens[0] = 0
    got = t_pa._split_plain(*(_t(x) for x in (q, kp, vp, lens, pt)), 0.125)
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()


# --------------------------------------- ragged paged attention (row 9)

def _ragged_case(nh, kvh, d, page, seed=0):
    """A 20-row chunk whose causal limit (96 keys) ends mid-split, decode
    rows at the split edges of 64-key splits, an idle slot, a fresh
    3-token prefill and padding rows; a table of 512 keys."""
    rng = np.random.RandomState(seed)
    ppmax = 512 // page
    lengths = _edge_lengths(64, page, ppmax * page)
    rows = [(0, 20, 96)]
    rows += [(20 + i, 1, n) for i, n in enumerate(lengths)]
    rows += [(0, 0, 0), (27, 3, 3)]
    T = 36
    B = len(rows)
    n_pages = B * ppmax + 1
    q = rng.randn(T, nh, d).astype(np.float32)
    kp, vp = _pool(rng, kvh, n_pages, page, d)
    pt = _table(rng, [kl for _, _, kl in rows], ppmax, page, n_pages)
    meta = [np.array([r[i] for r in rows], np.int32) for i in range(3)]
    return (q, kp, vp, *meta, pt)


def _ragged_jax(case, scale, interpret=False):
    return np.asarray(j_rpa.ragged_paged_attention(
        *(jnp.asarray(c) for c in case), scale=scale, use_pallas=interpret))


@pytest.mark.parametrize("tensor_tiles", [True, False],
                         ids=["bf16_schedule", "walk_schedule"])
@pytest.mark.parametrize("nh,kvh,d,page", LAYOUTS, ids=LAYOUT_IDS)
def test_ragged_split_plain_matches_jax(nh, kvh, d, page, tensor_tiles,
                                        small_splits):
    """The kernel's schedule and merge (64-key splits) in f32 math,
    under bf16's schedule (the chunk and the fresh prefill on 64-row
    tensor tiles) and f32's (every sequence on 8-row walk tiles), against
    the JAX package; padding rows are zeros."""
    case = _ragged_case(nh, kvh, d, page)
    scale = 1.0 / math.sqrt(d)
    want = _ragged_jax(case, scale)
    got = t_rpa._split_plain(*(_t(c) for c in case), scale,
                             tensor_tiles=tensor_tiles).numpy()
    assert np.all(got[30:] == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nh,kvh,d,page", LAYOUTS[:2], ids=LAYOUT_IDS[:2])
def test_ragged_split_plain_matches_pallas_interpret(nh, kvh, d, page,
                                                     small_splits):
    """The same against the JAX package's Pallas kernel in interpret
    mode, on a shorter table (interpret mode is slow)."""
    rng = np.random.RandomState(2)
    ppmax = 192 // page
    rows = [(0, 9, 100), (9, 1, 65), (0, 0, 0), (10, 1, 128)]
    T = 16
    n_pages = len(rows) * ppmax + 1
    q = rng.randn(T, nh, d).astype(np.float32)
    kp, vp = _pool(rng, kvh, n_pages, page, d)
    pt = _table(rng, [kl for _, _, kl in rows], ppmax, page, n_pages)
    meta = [np.array([r[i] for r in rows], np.int32) for i in range(3)]
    case = (q, kp, vp, *meta, pt)
    scale = 1.0 / math.sqrt(d)
    want = _ragged_jax(case, scale, interpret=True)
    got = t_rpa._split_plain(*(_t(c) for c in case), scale,
                             tensor_tiles=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_ragged_schedule_cuts_tiles_and_splits(small_splits):
    """The schedule the kernel runs, on `_ragged_case`'s rows (GQA 8/2:
    4 q heads a kv head): the chunk's 80 packed rows on two tensor tiles
    (the first's last row at position 91, the second's at 95: two 64-key
    splits each), decode rows on one walk tile each with
    ceil(length / 64) splits, the idle slot on none, the 3-token prefill
    (12 packed rows) on one tensor tile."""
    case = _ragged_case(8, 2, 64, 8)
    q_len, kv_len = _t(case[4]), _t(case[5])
    assert t_rpa._split_keys(512) == 64
    tiles = t_rpa._schedule(q_len, kv_len, 4, 512, True)
    assert [(r0, r1, live) for r0, r1, _, _, live in tiles[0]] == \
        [(0, 64, 2), (64, 80, 2)]
    assert [t[3] for t in tiles[0]] == [92, 96]
    lengths = _edge_lengths(64, 8, 512)
    assert [[(t[0], t[1], t[4]) for t in x] for x in tiles[1:8]] == \
        [[(0, 4, -(-n // 64))] for n in lengths]
    assert tiles[8] == [] and [(t[0], t[1]) for t in tiles[9]] == [(0, 12)]
    walk = t_rpa._schedule(q_len, kv_len, 4, 512, False)
    assert [(t[0], t[1]) for t in walk[0]] == [(r, r + 8)
                                               for r in range(0, 80, 8)]


def test_ragged_split_plain_bf16_matches_jax(small_splits):
    """bf16 inputs: the emulation pre-scales q in bf16, as the kernel
    and the reference's fallback do, and returns bf16 within one bf16
    rounding of the reference."""
    case = _ragged_case(8, 2, 64, 16)
    scale = 1.0 / math.sqrt(64)
    bf = [_t(c).to(torch.bfloat16) for c in case[:3]]
    want = np.asarray(j_rpa.ragged_paged_attention(
        *(jnp.asarray(c.float().numpy(), jnp.bfloat16) for c in bf),
        *(jnp.asarray(c) for c in case[3:]), scale=scale,
        use_pallas=False).astype(jnp.float32))
    got = t_rpa._split_plain(*bf, *(_t(c) for c in case[3:]), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=ATOL)


# ------------------------- verify entries on row tiles (speculation)

def _verify_case(nh, kvh, d, page, seed=0):
    """Speculative verify entries of q_len 2..9 (a decode row and its
    drafts) at kv lengths around the 64-key splits, a plain decode row, a
    12-row prefill chunk and an idle slot; every entry but the chunk is
    flagged for row tiles. A table of 256 keys."""
    rng = np.random.RandomState(seed)
    ppmax = 256 // page
    rows, cur = [], 0
    for ql, kl in zip(range(2, 10), (2, 9, 64, 66, 130, 127, 200, 256)):
        rows.append((cur, ql, kl))
        cur += ql
    rows += [(cur, 1, 65), (cur + 1, 12, 140), (0, 0, 0)]
    T = cur + 16
    B = len(rows)
    n_pages = B * ppmax + 1
    q = rng.randn(T, nh, d).astype(np.float32)
    kp, vp = _pool(rng, kvh, n_pages, page, d)
    pt = _table(rng, [kl for _, _, kl in rows], ppmax, page, n_pages)
    meta = [np.array([r[i] for r in rows], np.int32) for i in range(3)]
    flags = np.array([1] * 9 + [0, 0], np.int32)
    return (q, kp, vp, *meta, pt), flags


@pytest.mark.parametrize("tensor_tiles", [True, False],
                         ids=["bf16_schedule", "walk_schedule"])
@pytest.mark.parametrize("nh,kvh,d,page", [(4, 4, 64, 8), (8, 2, 64, 16)],
                         ids=["rep1_d64_p8", "rep4_d64_p16"])
def test_ragged_row_tiles_split_plain_matches_jax(nh, kvh, d, page,
                                                  tensor_tiles,
                                                  small_splits):
    """Verify entries (q_len 2-9) on row tiles, in the kernel's schedule
    and merge, against the JAX package at rep 1 and 4."""
    case, flags = _verify_case(nh, kvh, d, page)
    scale = 1.0 / math.sqrt(d)
    want = _ragged_jax(case, scale)
    got = t_rpa._split_plain(*(_t(c) for c in case), scale,
                             tensor_tiles=tensor_tiles,
                             row_tiles=_t(flags)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tensor_tiles", [True, False],
                         ids=["bf16_schedule", "walk_schedule"])
@pytest.mark.parametrize("rep", [1, 4])
def test_ragged_row_tiles_schedule_is_decode_rows(rep, tensor_tiles,
                                                  small_splits):
    """A flagged entry's tiles are its decode rows': local row i of an
    entry with q_len ql and kv_len kl is tiled exactly as a q_len = 1
    sequence at kv_len kl - ql + i + 1 (its rep packed rows, its causal
    limit, its live splits), for q_len 2-9; unflagged entries keep the
    tiling of the whole sequence."""
    case, flags = _verify_case(4 * rep, 4, 64, 8)
    q_len, kv_len = _t(case[4]), _t(case[5])
    S = case[6].shape[1] * 8
    got = t_rpa._schedule(q_len, kv_len, rep, S, tensor_tiles, _t(flags))
    plain = t_rpa._schedule(q_len, kv_len, rep, S, tensor_tiles)
    for s, (ql, kl) in enumerate(zip(q_len.tolist(), kv_len.tolist())):
        if not flags[s]:
            assert got[s] == plain[s]
            continue
        want = []
        for i in range(ql):
            (one,) = t_rpa._schedule(torch.tensor([1]),
                                     torch.tensor([kl - ql + i + 1]), rep,
                                     S, tensor_tiles)
            want += [(r0 + i * rep, r1 + i * rep, sk, kend, live)
                     for r0, r1, sk, kend, live in one]
        assert got[s] == want
        assert len(got[s]) == ql * (1 if rep <= 8 or tensor_tiles else
                                    -(-rep // 8))
    # unflagged, the 5-row entry at 66 keys is one walk tile of two
    # splits at rep 1, where its first row (62 keys) alone has one: the
    # walk's unroll and split count follow the tile's last row
    if rep == 1:
        assert plain[3] == [(0, 5, 64, 66, 2)]
        assert got[3][0] == (0, 1, 64, 62, 1)


def test_verify_bitwise_sends_each_row_at_its_own_position():
    """`testing.verify_bitwise` (the card's check) sends row j of every
    entry as a decode row at that row's own position: a stand-in kernel
    whose row t returns q[t] times its absolute position agrees on all
    20 rows of chip_smoke's verify case, and on none when the row tiles
    flag shifts every position by one."""
    rows = testing.RAGGED_CASES["verify"]["rows"]
    q_start, q_len, kv_len = (torch.tensor([r[i] for r in rows],
                                           dtype=torch.int32)
                              for i in range(3))
    q = torch.randn(128, 2, 8, generator=torch.Generator().manual_seed(0))

    def fake(q, kp, vp, qs, ql, kl, pt, row_tiles=None):
        out = torch.zeros_like(q)
        shift = 0 if row_tiles is None else int(row_tiles[0])
        for s_, l_, k_ in zip(qs.tolist(), ql.tolist(), kl.tolist()):
            for t in range(l_):
                out[s_ + t] = q[s_ + t] * (k_ - l_ + t + 1 + shift)
        return out

    args = (q, None, None, q_start, q_len, kv_len, None)
    assert testing.verify_bitwise(fake, args) == (20, 20)
    assert testing.verify_bitwise(fake, args, torch.ones(4)) == (0, 20)


# ------------------------------------------------------- shared helpers

@pytest.mark.parametrize("want,S,unit,expect", [
    (128, 1024, 16, 128), (100, 1024, 16, 96), (8, 1024, 16, 32),
    (128, 16384, 64, 512), (256, 64, 64, 256)],
    ids=["fits", "whole_units", "max_splits", "long_table", "one_split"])
def test_split_keys(want, S, unit, expect):
    """Keys per split: whole units, at most MAX_SPLITS splits."""
    sk = _paged_split.split_keys(want, S, unit)
    assert sk == expect and sk % unit == 0
    assert -(-S // sk) <= _paged_split.MAX_SPLITS


def test_split_attention_merge_is_exact():
    """Two splits merged equal one softmax over both; a row with no
    valid key is zero, one live split is o / l."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(3, 10, generator=g)
    v = torch.randn(3, 10, 4, generator=g)
    valid = torch.ones(3, 10, dtype=torch.bool)
    valid[2] = False
    got = _paged_split.split_attention(s, v, valid,
                                       torch.tensor([4, 16, 4]),
                                       torch.tensor([3, 1, 3]))
    want = torch.einsum("rs,rsd->rd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=1e-6)
    assert torch.all(got[2] == 0)


def test_chip_smoke_ragged_rows_are_testing_cases():
    """chip_smoke.py's RAGGED_ROWS (timed by `--ab` against checkouts
    whose testing.py lacks RAGGED_CASES) are the card tests' cases."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    for tag, rows in chip_smoke.RAGGED_ROWS.items():
        assert testing.RAGGED_CASES[tag] == {"rows": rows}
