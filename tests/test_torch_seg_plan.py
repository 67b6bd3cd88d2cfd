"""The segment kernels' design rules, mirrored in plain PyTorch
(`paddle_tpu_torch.testing`) and held on the CPU:

- the kv-tile visit plan of csrc/flash_wgmma.cu (`seg_visit_plan`): the
  segment attention over the visited tiles alone (`seg_plan_attention`)
  equals the reference's segment route — `flash_attention_bshd`'s
  `padding_mask=` (paddle_tpu/kernels/flash_attention.py:283, lowered to
  `SegmentIds` at l.332) and the packed route's explicit ids (l.406) —
  run as the reference's own tests run it on the CPU (the splash kernel
  in interpret mode, `_splash_gqa(..., interpret=True)`), every row, at
  the kernels' tiles and at small tiles that make the plan skip;
- the backward's two plans (dq: `seg_visit_plan` at dq's tiles; dkv:
  `seg_dkv_visit_plan`, the transposed rule): dq, dk and dv over each
  plan's visited tiles alone (`seg_plan_grads`) equal the reference's
  segment-route grads (`jax.vjp` through the same interpret-mode
  splash), and the dkv plan visits little more than the pairs packed
  documents need;
- the f32 kernels' 3xTF32 split (`tf32_split`) and their transposed
  operands' order (`vt_positions`), and that three tf32 products a
  product meet the f32 element limits of `testing.py` where one does
  not, in the forward and in the backward (dq, dk and dv with segments
  and GQA).

Limit for the plan: max|a - b| / max|b| <= 1e-5 (f32 summation order,
the attention tests' KERNEL_RTOL).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as j_fa
from paddle_tpu_torch import testing
from paddle_tpu_torch.kernels import flash_attention as t_fa

from _torch_threads import one_torch_thread  # noqa: F401,E402

KERNEL_RTOL = 1e-5

# (B, Sq, Sk, H, D, causal, kind): "packed" explicit 1-based ids of
# packed documents; "padded" a [B, Sk] padding mask; "cross_empty_row" a
# padding mask with Sq != Sk whose batch row 1 has no valid key (every
# query row of it has no key of its own segment); "qpad" packed ids whose
# last 37 query rows carry a segment no key holds. Such a row averages V
# over every key it sees. Causal, the port's rows see keys j <= i (a key
# above the diagonal takes -inf, csrc/flash_attention.cu's rule since the
# segment route was ported); splash masks those keys with the same
# finite value as the segments, so its rows average over the keys of the
# blocks it computes. The causal "qpad" case is therefore held against
# the port's own plain version (`_SegPlain`), the full causal route.
# (B, Sq, Sk, Hq, Hk, D, causal, kind); "gqa_packed_causal" runs two q
# heads a kv head.
PLAN_CASES = {
    "packed_causal": (1, 256, 256, 2, 2, 64, True, "packed"),
    "padded": (2, 256, 256, 2, 2, 64, False, "padded"),
    "cross_empty_row": (2, 128, 256, 2, 2, 64, False, "cross_empty_row"),
    "qpad": (1, 256, 256, 2, 2, 64, False, "qpad"),
    "qpad_causal": (1, 256, 256, 2, 2, 64, True, "qpad"),
    "gqa_packed_causal": (1, 256, 256, 4, 2, 64, True, "packed"),
}
CAUSAL = 6
# (q rows a block, keys a tile): the kernels' (bf16; f32 at D = 64 and
# at D = 128) and two small ones at which the plan skips at these sizes
PLAN_TILES = {"bf16": (128, 128), "f32_d64": (128, 64),
              "f32_d128": (128, 32), "small_16x8": (16, 8),
              "small_32x16": (32, 16)}


def _case(name, seed=0):
    """numpy q [B, Sq, Hq, D], k, v [B, Sk, Hk, D]; int32 seg_q [B, Sq],
    seg_kv [B, Sk]; the padding mask [B, Sk] or None."""
    B, Sq, Sk, Hq, Hk, D, causal, kind = PLAN_CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hk, D)).astype(np.float32)
    pm = None
    if kind in ("padded", "cross_empty_row"):
        pm = np.arange(Sk)[None, :] < np.array([Sk - 37, Sk])[:B, None]
        if kind == "cross_empty_row":
            pm[1] = False
        seg_q, seg_kv = (t.numpy() for t in t_fa.padding_segments(
            torch.from_numpy(pm), Sq, Sk))
    else:
        cu = np.array([0, 70, 71, 200, Sk])
        seg_kv = np.repeat(np.arange(1, len(cu)), np.diff(cu)).astype(
            np.int32)[None]
        seg_q = seg_kv.copy()
        if kind == "qpad":
            seg_q[:, -37:] = 0
    return q, k, v, seg_q, seg_kv, pm


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's segment route on the case, as numpy [B, Sq, H, D]:
    the splash kernel in interpret mode with `padding_mask=` (lowered to
    SegmentIds inside) or explicit segment ids; for "qpad_causal" the
    port's `_SegPlain` (see PLAN_CASES)."""
    q, k, v, seg_q, seg_kv, pm = _case(name)
    causal = PLAN_CASES[name][CAUSAL]
    if name == "qpad_causal":
        q, k, v = (torch.from_numpy(t) for t in (q, k, v))
        return t_fa._SegPlain.apply(q, k, v, torch.from_numpy(seg_q),
                                    torch.from_numpy(seg_kv), True,
                                    q.shape[-1] ** -0.5).numpy()
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k, v))
    o = j_fa._splash_gqa(
        qt, kt, vt, causal, 1.0 / np.sqrt(q.shape[-1]),
        None if pm is None else jnp.asarray(pm), interpret=True,
        segments=None if pm is not None else (jnp.asarray(seg_q),
                                              jnp.asarray(seg_kv)))
    return np.asarray(jnp.swapaxes(o, 1, 2))


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _plan_inputs(name):
    q, k, v, seg_q, seg_kv, _ = _case(name)
    return ([torch.from_numpy(t) for t in (q, k, v)],
            torch.from_numpy(seg_q), torch.from_numpy(seg_kv))


@pytest.mark.parametrize("tiles", list(PLAN_TILES))
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_visited_tiles_give_the_reference_segment_route(name, tiles):
    """Attention restricted to the plan's visited tiles equals the
    reference's segment route, every row (rows with no key of their own
    segment included: their blocks visit every tile)."""
    (q, k, v), seg_q, seg_kv = _plan_inputs(name)
    causal = PLAN_CASES[name][CAUSAL]
    BM, BN = PLAN_TILES[tiles]
    o, lse = testing.seg_plan_attention(q, k, v, seg_q, seg_kv, causal,
                                        q.shape[-1] ** -0.5, BM, BN)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert _max_rel(o, _reference(name)) <= KERNEL_RTOL


@pytest.mark.parametrize("name", ["packed_causal", "padded"])
def test_plan_skips_where_segments_allow(name):
    """At small tiles the packed and padded cases leave whole tiles out
    (the kernels' skipping is exercised, not vacuous), and every skipped
    tile shares no segment with its block's rows."""
    _, seg_q, seg_kv = _plan_inputs(name)
    causal = PLAN_CASES[name][CAUSAL]
    BM, BN = PLAN_TILES["small_16x8"]
    plan = testing.seg_visit_plan(seg_q, seg_kv, causal, BM, BN)
    B, n_qt, n_kt = plan.shape
    skipped = 0
    for b in range(B):
        for i in range(n_qt):
            kv_end = min(seg_kv.shape[1], (i + 1) * BM) if causal \
                else seg_kv.shape[1]
            qs = set(seg_q[b, i * BM:(i + 1) * BM].tolist())
            for j in range(-(-kv_end // BN)):
                if not plan[b, i, j]:
                    skipped += 1
                    assert not qs & set(
                        seg_kv[b, j * BN:(j + 1) * BN].tolist())
    assert skipped > 0


def test_rows_without_own_key_need_every_tile():
    """The own-position rule is what makes the plan exact: a plan from
    the segment ranges alone skips every tile of the batch row that has
    no valid key, and the attention over it is no longer the
    reference's."""
    name = "cross_empty_row"
    (q, k, v), seg_q, seg_kv = _plan_inputs(name)
    BM, BN = PLAN_TILES["small_16x8"]
    plan = testing.seg_visit_plan(seg_q, seg_kv, False, BM, BN)
    assert bool(plan[1].all())
    # ranges alone: row 1's queries (segment 1) against keys of segment 0
    kv = seg_kv.view(seg_kv.shape[0], -1, BN)
    qb = seg_q.view(seg_q.shape[0], -1, BM)
    ranges_only = ~((kv.amax(-1)[:, None, :] < qb.amin(-1)[:, :, None])
                    | (kv.amin(-1)[:, None, :] > qb.amax(-1)[:, :, None]))
    assert not bool(ranges_only[1].any())
    s = t_fa._seg_scores(q, k, seg_q, seg_kv, False, q.shape[-1] ** -0.5)
    keep = ranges_only.repeat_interleave(BM, 1).repeat_interleave(BN, 2)
    o = torch.softmax(s.masked_fill(~keep[:, None], float("-inf")), -1) \
        @ v.transpose(1, 2)
    assert not _max_rel(o.transpose(1, 2).nan_to_num(), _reference(name)) \
        <= KERNEL_RTOL


@functools.lru_cache(maxsize=None)
def _reference_grads(name):
    """The reference's segment-route grads (dq, dk, dv) on the case, as
    numpy BSHD: `jax.vjp` through the interpret-mode splash kernel, as
    tests/test_torch_attention.py runs it, with a seeded cotangent; for
    "qpad_causal" the port's `_SegPlain` backward (see PLAN_CASES).
    Returns (grads, the cotangent)."""
    import jax

    q, k, v, seg_q, seg_kv, pm = _case(name)
    causal = PLAN_CASES[name][CAUSAL]
    do = np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    if name == "qpad_causal":
        leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
        o = t_fa._SegPlain.apply(*leaves, torch.from_numpy(seg_q),
                                 torch.from_numpy(seg_kv), True, scale)
        o.backward(torch.from_numpy(do))
        return tuple(t.grad.numpy() for t in leaves), do

    def ref(q_, k_, v_):
        qt, kt, vt = (jnp.swapaxes(t, 1, 2) for t in (q_, k_, v_))
        o = j_fa._splash_gqa(
            qt, kt, vt, causal, scale,
            None if pm is None else jnp.asarray(pm), interpret=True,
            segments=None if pm is not None else (jnp.asarray(seg_q),
                                                  jnp.asarray(seg_kv)))
        return jnp.swapaxes(o, 1, 2)

    _, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (q, k, v)))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do))), do


# the backward's (dq, dkv) tiles: the kernels' (testing.SEG_BWD_TILES:
# bf16, and f32 at both head dims) and two small ones at which both
# plans skip at these sizes
GRAD_TILES = {"bf16": testing.SEG_BWD_TILES[(torch.bfloat16, 64)],
              "f32_d64": testing.SEG_BWD_TILES[(torch.float32, 64)],
              "f32_d128": testing.SEG_BWD_TILES[(torch.float32, 128)],
              "small_16x8": {"dq": (16, 8), "dkv": (16, 8)},
              "small_32x16": {"dq": (32, 16), "dkv": (32, 16)}}


@pytest.mark.parametrize("tiles", list(GRAD_TILES))
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_visited_tiles_give_the_reference_segment_grads(name, tiles):
    """dq over the dq plan's visited tiles and dk, dv over the dkv plan's
    equal the reference's segment-route grads, every row (rows with no
    key of their own segment included)."""
    (q, k, v), seg_q, seg_kv = _plan_inputs(name)
    want, do = _reference_grads(name)
    got = testing.seg_plan_grads(q, k, v, torch.from_numpy(do), seg_q,
                                 seg_kv, PLAN_CASES[name][CAUSAL],
                                 q.shape[-1] ** -0.5, GRAD_TILES[tiles])
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _max_rel(g, w) <= KERNEL_RTOL


@pytest.mark.parametrize("name", ["packed_causal", "padded",
                                  "cross_empty_row"])
def test_dkv_plan_skips_where_segments_allow(name):
    """At small tiles the dkv plan leaves whole q tiles out, and every
    skipped tile shares no segment with its kv block and has a key of
    its own segment at each row's position."""
    _, seg_q, seg_kv = _plan_inputs(name)
    causal = PLAN_CASES[name][CAUSAL]
    BM, BN = 16, 8
    plan = testing.seg_dkv_visit_plan(seg_q, seg_kv, causal, BM, BN)
    B, n_kb, n_qt = plan.shape
    Sq, Sk = seg_q.shape[1], seg_kv.shape[1]
    skipped = 0
    for b in range(B):
        for i in range(n_kb):
            keys = set(seg_kv[b, i * BM:(i + 1) * BM].tolist())
            for j in range(i * BM // BN if causal else 0, n_qt):
                if plan[b, i, j]:
                    continue
                skipped += 1
                rows = range(j * BN, min((j + 1) * BN, Sq))
                assert not keys & {int(seg_q[b, r]) for r in rows}
                assert all(r < Sk and seg_kv[b, r] == seg_q[b, r]
                           for r in rows)
    assert skipped > 0


def test_dkv_plan_never_skips_a_row_without_its_own_key():
    """A q tile holding a row with no key of its own segment (P = 1 on
    every key it sees) is visited by every kv block that walks it, even
    where the segment ranges are disjoint: "cross_empty_row"'s batch row
    1 has no valid key, and "qpad"'s last 37 rows a segment no key
    holds."""
    BM, BN = 16, 8
    for name in ("cross_empty_row", "qpad", "qpad_causal"):
        _, seg_q, seg_kv = _plan_inputs(name)
        causal = PLAN_CASES[name][CAUSAL]
        plan = testing.seg_dkv_visit_plan(seg_q, seg_kv, causal, BM, BN)
        Sq, Sk = seg_q.shape[1], seg_kv.shape[1]
        own = torch.zeros_like(seg_q, dtype=torch.bool)
        n = min(Sq, Sk)
        own[:, :n] = seg_kv[:, :n] == seg_q[:, :n]
        lacking = ~own.view(seg_q.shape[0], -1, BN).all(-1)     # [B, n_qt]
        assert bool(lacking.any())
        for i in range(plan.shape[1]):
            start = i * BM // BN if causal else 0
            assert bool(plan[:, i, start:][lacking[:, start:]].all())
    # the ranges alone would skip row 1's tiles of "cross_empty_row":
    # its queries are segment 1, every key segment 0
    _, seg_q, seg_kv = _plan_inputs("cross_empty_row")
    assert int(seg_kv[1].max()) == 0 and int(seg_q[1].min()) == 1


def test_dkv_plan_visits_little_more_than_packed_documents_need():
    """At the attention surface's packed causal 8192 tokens (testing.
    packed_lengths, the documents of `ATTN_SEG_CASES["packed_7b"]`) the
    causal pairs in the q tiles the dkv plan visits at the kernel's tiles
    are at most 1.3x the pairs the documents need (every causal tile:
    5.7x)."""
    lengths = testing.packed_lengths()
    seg = torch.repeat_interleave(
        torch.arange(1, len(lengths) + 1, dtype=torch.int32),
        torch.tensor(lengths))[None]
    S = seg.shape[1]
    need = sum(n * (n + 1) // 2 for n in lengths)
    BM, BN = testing.SEG_BWD_TILES[(torch.bfloat16, 128)]["dkv"]
    plan = testing.seg_dkv_visit_plan(seg, seg, True, BM, BN)
    keep = testing.seg_plan_keep(plan, BM, BN, S, S)[0]     # [key, query]
    visited = int(keep.t().tril().sum())
    assert visited <= 1.3 * need
    assert S * (S + 1) // 2 > 5.5 * need


@pytest.mark.parametrize("tiles", ["f32_d64", "f32_d128"])
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_dkv_plan_at_the_f32_tiles(name, tiles):
    """At the f32 kernels' dkv tiles (testing.SEG_BWD_TILES) every q tile
    the dkv plan skips shares no segment with its kv block and has a key
    of its own segment at each row's position (so a tile holding a row
    with no key of its own segment is visited by each block that walks
    it), and the packed and padded cases skip some."""
    _, seg_q, seg_kv = _plan_inputs(name)
    causal = PLAN_CASES[name][CAUSAL]
    BM, BN = GRAD_TILES[tiles]["dkv"]
    plan = testing.seg_dkv_visit_plan(seg_q, seg_kv, causal, BM, BN)
    B, n_kb, n_qt = plan.shape
    Sq, Sk = seg_q.shape[1], seg_kv.shape[1]
    skipped = 0
    for b in range(B):
        for i in range(n_kb):
            keys = set(seg_kv[b, i * BM:(i + 1) * BM].tolist())
            for j in range(i * BM // BN if causal else 0, n_qt):
                if plan[b, i, j]:
                    continue
                skipped += 1
                rows = range(j * BN, min((j + 1) * BN, Sq))
                assert all(r < Sk and seg_kv[b, r] == seg_q[b, r]
                           for r in rows)
                assert not keys & {int(seg_q[b, r]) for r in rows}
    if name in ("packed_causal", "padded", "gqa_packed_causal"):
        assert skipped > 0


def test_tf32_split_reconstructs_within_2_pow_22():
    """x = hi + lo with hi, lo tf32 (low 13 bits zero), |x - hi - lo| <=
    2^-22 |x|, over magnitudes from 2^-60 to 2^60 and both signs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(20000, generator=g) * torch.exp2(
        torch.randint(-60, 61, (20000,), generator=g).float())
    hi, lo = testing.tf32_split(x)
    for t in (hi, lo):
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # to nearest: hi is within half a tf32 ulp (2^-11 relative)
    assert bool(((x.double() - hi.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())


@pytest.mark.parametrize("n", [8, 32, 64, 128])
def test_vt_key_order_is_a_bijection_per_group_of_8(n):
    """V^T's k order permutes keys within each group of 8 only, and puts
    the score accumulators' pair (2c, 2c + 1) at the tf32 A fragment's
    columns (c, c + 4)."""
    pos = testing.vt_positions(n)
    assert sorted(pos.tolist()) == list(range(n))
    assert bool(((pos // 8) == (torch.arange(n) // 8)).all())
    order = torch.empty_like(pos)
    order[pos] = torch.arange(n)                      # key at each position
    assert order[:8].tolist() == list(testing.VT_KEY_ORDER)
    for c in range(4):
        assert (int(order[c]), int(order[c + 4])) == (2 * c, 2 * c + 1)


def _emulated(q, k, v, split):
    """Attention in f64 with every product of its two matmuls formed as
    the f32 forward forms it: split=3 from hi/lo tf32 parts (hi hi + hi
    lo + lo hi), split=1 from one tf32 rounding, split=0 exactly.
    Returns (o [B, H, S, D], lse [B, H, S])."""
    def mm(a, b):
        if split == 0:
            return a.double() @ b.double()
        if split == 1:
            return testing.tf32_round(a).double() \
                @ testing.tf32_round(b).double()
        ah, al = testing.tf32_split(a)
        bh, bl = testing.tf32_split(b)
        return (ah.double() @ bl.double() + al.double() @ bh.double()
                + ah.double() @ bh.double())

    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None]).float()
    return mm(p, vh), lse


def test_three_tf32_products_meet_the_f32_limits():
    """At BERT-like inputs (N(0, 1), D = 64) three tf32 products a
    product keep o within a small share of the f32 limit (testing.
    TERM_FRAC: 1e-4 of each element's sum of |terms|) and lse within 1e-4
    + 1e-5 |lse|; one tf32 product misses both. Products exact in f64,
    as the tensor cores form a tf32 product exactly."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 256, 2, 64, generator=g) for _ in range(3))
    o_x, lse_x = _emulated(q, k, v, 0)
    s = (q.transpose(1, 2).double()
         @ k.transpose(1, 2).double().transpose(-1, -2)) * 64 ** -0.5
    terms = torch.softmax(s, -1) @ v.transpose(1, 2).double().abs()
    frac = testing.TERM_FRAC[torch.float32]
    readings = {}
    for split in (3, 1):
        o, lse = _emulated(q, k, v, split)
        readings[split] = (
            testing.worst(o, o_x, frac * terms, 0.0),
            testing.worst(lse, lse_x, 1e-4, 1e-5))
    assert max(readings[3]) < 0.05
    assert min(readings[1]) > 1.0


def _mm(a, b, split):
    """a @ b in f64 with the products formed as the f32 kernels form
    them: split=3 from hi/lo tf32 parts (hi lo + lo hi + hi hi), split=1
    from one tf32 rounding, split=0 exactly."""
    if split == 0:
        return a.double() @ b.double()
    if split == 1:
        return testing.tf32_round(a).double() @ testing.tf32_round(b).double()
    ah, al = testing.tf32_split(a)
    bh, bl = testing.tf32_split(b)
    return (ah.double() @ bl.double() + al.double() @ bh.double()
            + ah.double() @ bh.double())


def _emulated_bwd(q, k, v, do, seg_q, seg_kv, split):
    """The segment backward in f64 with its five products (S, dP, dV +=
    P^T dO, dK += dS^T Q, dQ += dS K) formed by `_mm`; P and dS enter
    their products as the f32 values the kernels hold in registers. The
    forward's lse and D = rowsum(dO O) exact. Returns (dq, dk, dv) BSHD."""
    group = q.shape[2] // k.shape[2]
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    kh, vh = (t.repeat_interleave(group, dim=1) for t in (kh, vh))
    same = seg_q[:, None, :, None] == seg_kv[:, None, None, :]
    s_x = torch.where(same, _mm(qh, kh.transpose(-1, -2), 0) * scale,
                      t_fa._SEG_MASK)
    lse = torch.logsumexp(s_x, -1, keepdim=True)
    o = torch.softmax(s_x, -1) @ vh.double()
    delta = (doh.double() * o).sum(-1, keepdim=True)
    s = torch.where(same, _mm(qh, kh.transpose(-1, -2), split) * scale,
                    t_fa._SEG_MASK)
    p = torch.exp(s - lse).float()
    ds = (p.double() * (_mm(doh, vh.transpose(-1, -2), split)
                        - delta)).float()
    dq = _mm(ds, kh, split) * scale
    dk = t_fa._group_sum(_mm(ds.transpose(-1, -2), qh, split), group) * scale
    dv = t_fa._group_sum(_mm(p.transpose(-1, -2), doh, split), group)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def test_three_tf32_products_meet_the_f32_limits_in_the_backward():
    """At BERT-like inputs (N(0, 1), D = 64, padding segments with a
    short row, GQA 4 / 2) three tf32 products a product keep dq, dk and
    dv within a small share of the f32 limit (testing.TERM_FRAC: 1e-4 of
    each element's sum of |terms|, `seg_flash_terms`, which counts |dP| +
    |D| in dS so the cancellation in dP - D is covered); one tf32 product
    misses it on each. Products exact in f64, as the tensor cores form a
    tf32 product exactly."""
    g = torch.Generator().manual_seed(0)
    B, S, hq, hk, D = 2, 256, 4, 2, 64
    q, do = (torch.randn(B, S, hq, D, generator=g) for _ in range(2))
    k, v = (torch.randn(B, S, hk, D, generator=g) for _ in range(2))
    pm = torch.arange(S)[None, :] < torch.tensor([S, 190])[:, None]
    seg_q, seg_kv = t_fa.padding_segments(pm, S, S)
    exact = _emulated_bwd(q, k, v, do, seg_q, seg_kv, 0)
    terms = testing.seg_flash_terms(q, k, v, do, seg_q, seg_kv, False,
                                    D ** -0.5)[1:]
    frac = testing.TERM_FRAC[torch.float32]
    readings = {split: [testing.worst(got, want, frac * t, 0.0)
                        for got, want, t in zip(
                            _emulated_bwd(q, k, v, do, seg_q, seg_kv, split),
                            exact, terms)]
                for split in (3, 1)}
    assert max(readings[3]) < 0.05, readings
    assert min(readings[1]) > 1.0, readings
