"""Port attention surface (paddle_tpu_torch: the segment-id flash route of
`flash_attention_bshd(padding_mask=)`, `flash_attention_packed`,
`block_attention_stats`, `flash_attention_biased`, and the
`nn.functional` / `nn.MultiHeadAttention` surface on top of them)
against the JAX package, in fp32 on the CPU, from the same seeded numpy
inputs.

The reference's MHA flash kernel has no interpret mode, so the
segment-id plain version (`_SegPlain`) is held against the splash kernel
in interpret mode (`_splash_gqa(..., interpret=True)` with
`padding_mask=` or `segments=`; group 1 for MHA) — forward and VJP,
every row, including a query row with no key of its own segment (both
average V over the keys, and both backwards recompute P = 1 from an LSE
that rounds to the mask value). `block_attention_stats` is held against
the reference's Pallas kernel in interpret mode (`_FORCE_PALLAS`, as the
reference's own tests set it) and its `_dense_stats`, every row.

The reference's `nn.functional` and `MultiHeadAttention` take their dense
`_sdpa_ref` route on the CPU, where a padded query row attends to the
valid keys; the port runs the kernels' functions on both devices, and
its sdpa lowers a boolean padding mask to key ids alone, so a padded
query row attends to the valid keys there too: every row and every
grad compare whole. `flash_attention_bshd(padding_mask=)` keeps the
reference's TPU lowering (query ids too when Sq == Sk), held above
against the splash kernel.

Limits, as max|a - b| / max|b|: KERNEL_RTOL 1e-5 for one kernel's plain
version (f32 summation order), SURFACE_RTOL 1e-5 for the functionals and
layers (a projection or two around the same kernel).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.kernels import block_attention as j_ba
from paddle_tpu.kernels import flash_attention as j_fa
from paddle_tpu.nn.functional import attention as j_attn
from paddle_tpu.nn.layer.transformer import MultiHeadAttention as JMHA
from paddle_tpu_torch.kernels import block_attention as t_ba
from paddle_tpu_torch.kernels import flash_attention as t_fa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as t_attn
from paddle_tpu_torch.nn.layer import MultiHeadAttention as TMHA

from _torch_threads import one_torch_thread  # noqa: F401,E402

KERNEL_RTOL = 1e-5
SURFACE_RTOL = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _lengths_mask(lengths, S):
    return np.arange(S)[None, :] < np.asarray(lengths)[:, None]


# ------------------------------------------------- segment-id flash route


# (B, Sq, Sk, Hq, Hk, D, causal, kind): kind "pad" is a [B, Sk] padding
# mask (with Sq != Sk, batch row 1 has no valid key at all), "packed"
# explicit 1-based segment ids of packed sequences at batch 1
SEG_CASES = {
    "mha_full_d64_pad": (2, 128, 128, 2, 2, 64, False, "pad"),
    "mha_causal_d128_pad": (2, 128, 128, 2, 2, 128, True, "pad"),
    "gqa_causal_d64_pad": (2, 128, 128, 4, 2, 64, True, "pad"),
    "mqa_full_d128_pad": (1, 128, 128, 4, 1, 128, False, "pad"),
    "mha_cross_sq_ne_sk_d64_pad": (2, 128, 256, 2, 2, 64, False, "pad"),
    "gqa_cross_sq_ne_sk_d128_pad": (2, 128, 256, 4, 2, 128, False, "pad"),
    "mha_packed_causal_d64": (1, 256, 256, 2, 2, 64, True, "packed"),
    "gqa_packed_full_d128": (1, 256, 256, 4, 2, 128, False, "packed"),
}


def _seg_inputs(case, seed=0):
    B, Sq, Sk, hq, hk, d, causal, kind = case
    rng = np.random.default_rng(seed)
    q, do = _rand(rng, B, Sq, hq, d), _rand(rng, B, Sq, hq, d)
    k, v = _rand(rng, B, Sk, hk, d), _rand(rng, B, Sk, hk, d)
    if kind == "pad":
        pm = _lengths_mask([Sk - 37, Sk][:B], Sk)
        if Sq != Sk:
            pm[1] = False
        return q, k, v, do, pm, None
    cu = np.array([0, 70, 71, 200, Sk])
    seg = np.repeat(np.arange(1, len(cu)), np.diff(cu)).astype(np.int32)
    return q, k, v, do, None, (seg[None], seg[None])


@pytest.mark.parametrize("name", list(SEG_CASES))
def test_segment_plain_matches_interpret_splash(name):
    """Forward and VJP of the segment-id route, every row, against the
    reference's splash kernel in interpret mode."""
    case = SEG_CASES[name]
    B, Sq, Sk, hq, hk, d, causal, kind = case
    q, k, v, do, pm, segs = _seg_inputs(case)
    scale = 1.0 / np.sqrt(d)

    def ref(q_, k_, v_):
        qt, kt, vt = (jnp.swapaxes(t, 1, 2) for t in (q_, k_, v_))
        o = j_fa._splash_gqa(
            qt, kt, vt, causal, scale,
            None if pm is None else jnp.asarray(pm), interpret=True,
            segments=None if segs is None else tuple(
                jnp.asarray(s) for s in segs))
        return jnp.swapaxes(o, 1, 2)

    o_j, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    if pm is not None:
        o = t_fa.flash_attention_bshd(qt, kt, vt, causal=causal,
                                      padding_mask=torch.from_numpy(pm))
    else:
        o = t_fa.flash_attention_packed(
            qt[0], kt[0], vt[0], torch.from_numpy(segs[0][0]),
            torch.from_numpy(segs[1][0]), causal=causal)[None]
    o.backward(_t(do))
    assert _max_rel(o.detach(), o_j) <= KERNEL_RTOL
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert _max_rel(got, want) <= KERNEL_RTOL


def test_row_without_own_segment_averages_values():
    """A query row whose batch row has no valid key (Sq != Sk): the
    output is the mean of V over the keys, as upstream's finite mask
    value gives."""
    q, k, v, _, pm, _ = _seg_inputs(SEG_CASES["mha_cross_sq_ne_sk_d64_pad"])
    o = t_fa.flash_attention_bshd(_t(q), _t(k), _t(v),
                                  padding_mask=torch.from_numpy(pm))
    want = v[1].mean(0)[None]                              # [1, H, D]
    assert _max_rel(o[1].numpy(), np.broadcast_to(want, o[1].shape)) <= 1e-6


def test_padding_segments_lowering():
    pm = torch.tensor([[1, 1, 0], [1, 0, 0]])
    sq, skv = t_fa.padding_segments(pm, 3, 3)
    assert sq.dtype == torch.int32 and torch.equal(sq, skv)
    assert skv.tolist() == [[1, 1, 0], [1, 0, 0]]
    sq, _ = t_fa.padding_segments(pm, 5, 3)
    assert sq.tolist() == [[1] * 5] * 2


# ----------------------------------------------------- block-stats kernel


@pytest.fixture
def force_pallas(monkeypatch):
    """The reference's block-stats Pallas kernel in interpret mode (its
    own tests' fixture; a test-time attribute, no file is edited)."""
    monkeypatch.setattr(j_ba, "_FORCE_PALLAS", True)


# (B, Sq, Sk, H, D, mask, bias shape or None, special)
STATS_CASES = {
    "plain_d64": (1, 128, 256, 2, 64, False, None, None),
    "mask_d128": (2, 128, 128, 2, 128, True, None, None),
    "bias_full": (1, 128, 256, 2, 64, False, "full", None),
    "bias_narrow_dbias_reduced": (2, 128, 128, 2, 64, False, "narrow", None),
    "masked_rows_and_neg_inf_bias": (1, 128, 128, 2, 64, True, "full",
                                     "masked"),
    "sk640": (1, 128, 640, 1, 64, True, None, None),
    # a ring-attention diagonal round: no bias, the causal mask
    "ring_causal": (1, 256, 256, 2, 128, "causal", None, None),
}


def _stats_inputs(case, seed=1):
    B, Sq, Sk, H, D, use_mask, bias_kind, special = case
    rng = np.random.default_rng(seed)
    q = _rand(rng, B, Sq, H, D)
    k, v = _rand(rng, B, Sk, H, D), _rand(rng, B, Sk, H, D)
    if use_mask == "causal":
        mask = np.tril(np.ones((Sq, Sk), bool))
    else:
        mask = rng.random((Sq, Sk)) > 0.3 if use_mask else None
    bias = None
    if bias_kind == "full":
        bias = 0.5 * _rand(rng, B, H, Sq, Sk)
    elif bias_kind == "narrow":
        bias = 0.5 * _rand(rng, B, 1, 1, Sk)
    if special == "masked":
        mask[5] = False                        # a fully masked row
        bias[0, 1, 9, :] = -np.inf             # a fully -inf row
        bias[0, 0, :, 3] = -np.inf             # one -inf key
        bias[0, 0, 11, :] = -1e30              # a row at the mask value
    return q, k, v, mask, bias


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_block_stats_matches_interpret_pallas(name, force_pallas):
    """(m, l, o) and the VJP in q, k, v (and the bias) against the
    reference's Pallas kernel in interpret mode, and the forward against
    its `_dense_stats` too."""
    q, k, v, mask, bias = _stats_inputs(STATS_CASES[name])
    scale = 0.125
    rng = np.random.default_rng(2)
    ct_l = _rand(rng, q.shape[0], q.shape[2], q.shape[1])
    ct_o = _rand(rng, *q.shape)
    jm = None if mask is None else jnp.asarray(mask)
    jb = None if bias is None else jnp.asarray(bias)

    def ref(q_, k_, v_, b_):
        return j_ba.block_attention_stats(q_, k_, v_, jm, scale, b_)

    (m_j, l_j, o_j), vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jb)
    grads_j = vjp((jnp.zeros_like(m_j), jnp.asarray(ct_l),
                   jnp.asarray(ct_o)))
    m_d, l_d, o_d = j_ba._dense_stats(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jm, scale, jb)
    leaves = [_t(q, True), _t(k, True), _t(v, True)]
    bt = None if bias is None else _t(bias, True)
    m, l, o = t_ba.block_attention_stats(
        *leaves, None if mask is None else torch.from_numpy(mask), scale, bt)
    torch.autograd.backward((l, o), (_t(ct_l), _t(ct_o)))
    for got, want, want_d in ((m, m_j, m_d), (l, l_j, l_d), (o, o_j, o_d)):
        assert bool(torch.isfinite(got).all())
        assert _max_rel(got.detach(), want) <= KERNEL_RTOL
        assert _max_rel(got.detach(), want_d) <= KERNEL_RTOL
    got_grads = [t.grad for t in leaves] + ([bt.grad] if bt is not None
                                            else [])
    for got, want in zip(got_grads, grads_j):
        assert got.shape == tuple(want.shape)
        assert _max_rel(got, want) <= KERNEL_RTOL
    if name == "masked_rows_and_neg_inf_bias":
        # fully masked rows give (-1e30, 0, 0)
        m, l, o = m.detach(), l.detach(), o.detach()
        for h, row in ((0, 5), (1, 9), (0, 11)):
            assert float(m[0, h, row]) == float(np.float32(-1e30))
            assert float(l[0, h, row]) == 0.0
            assert bool((o[0, row, h] == 0).all())


def test_block_stats_refusals():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ba.block_attention_stats(q, q, q, None, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="does not take"):
        t_ba.block_attention_stats(torch.zeros(1, 128, 2, 96),
                                   torch.zeros(1, 128, 2, 96),
                                   torch.zeros(1, 128, 2, 96), None, 0.1,
                                   use_kernel=True)


# -------------------------------------------------------- biased route


# (B, Sq, Sk, Hq, Hk, D, kind, causal, chunk, special): special "pad" is
# a [B, Sk] padding mask with a short row; "masked" a padding mask whose
# batch row 1 has no valid key, and a dense bias holding -inf (one key,
# one whole row) and -1e30 (another whole row): rows with no valid key
# give output 0 and grads 0
BIASED_CASES = {
    "alibi_causal_gqa": (2, 128, 128, 4, 2, 64, "alibi", True, 64, None),
    "alibi_full_gqa": (1, 128, 256, 4, 2, 64, "alibi", False, 128, None),
    "rel_table_grads": (1, 96, 96, 2, 2, 64, "rel_table", True, 32, None),
    "dense_padding_mask": (2, 128, 128, 2, 2, 64, "dense", True, 64, "pad"),
    "sk_not_a_chunk_multiple": (1, 128, 300, 2, 2, 64, "dense", False, 128,
                                "pad"),
    "alibi_causal_sq_lt_sk": (1, 96, 160, 4, 2, 64, "alibi", True, 64,
                              None),
    "dense_causal_sq_gt_sk_mqa": (1, 160, 96, 4, 1, 128, "dense", True, 64,
                                  None),
    "rel_table_full_gqa_pad": (2, 64, 128, 4, 2, 128, "rel_table", False,
                               64, "pad"),
    "dense_masked_rows_neg_inf": (2, 64, 96, 4, 2, 64, "dense", False, 64,
                                  "masked"),
    "alibi_causal_masked_rows": (2, 96, 64, 2, 2, 64, "alibi", True, 32,
                                 "masked"),
}


def _biased_inputs(name, seed=3):
    """Inputs of a BIASED_CASES case: q, k, v, do, the bias parameter, R,
    the padding mask (or None) and the scale; numpy f32."""
    B, Sq, Sk, hq, hk, d, kind, causal, chunk, special = BIASED_CASES[name]
    rng = np.random.default_rng(seed)
    q, do = _rand(rng, B, Sq, hq, d), _rand(rng, B, Sq, hq, d)
    k, v = _rand(rng, B, Sk, hk, d), _rand(rng, B, Sk, hk, d)
    R = 8
    if kind == "alibi":
        param = (2.0 ** -np.arange(1, hq + 1)).astype(np.float32)
    elif kind == "rel_table":
        param = 0.3 * _rand(rng, hq, 2 * R + 1)
    elif special == "masked":
        param = 0.5 * _rand(rng, B, 1, Sq, Sk)
        param[0, 0, :, 3] = -np.inf
        param[0, 0, 7, :] = -np.inf
        param[0, 0, 9, :] = -1e30
    else:
        param = 0.5 * _rand(rng, B, 1, 1, Sk)
    pm = None
    if special == "pad":
        pm = _lengths_mask([Sk - 29, Sk][:B], Sk)
    elif special == "masked":
        pm = _lengths_mask([Sk - 5, 0], Sk)
    return q, k, v, do, param, R, pm, 1.0 / np.sqrt(d)


def _reference_biased(name, q, k, v, param, R, pm, scale):
    """The reference's flash_attention_biased (jnp block stats) as a
    function of (q, k, v, param), and its dense log-sum-exp per row
    (+inf where no key is valid)."""
    kind, causal, chunk = BIASED_CASES[name][6:9]
    (B, Sq, hq, _), (Sk, hk) = q.shape, k.shape[1:3]
    jpm = None if pm is None else jnp.asarray(pm)

    def ref(q_, k_, v_, p_):
        return j_fa.flash_attention_biased(
            q_, k_, v_, kind, (p_, R) if kind == "rel_table" else p_,
            causal=causal, scale=scale, padding_mask=jpm, chunk=chunk,
            use_pallas=False)

    bias = j_fa._bias_chunk(kind, (jnp.asarray(param), R)
                            if kind == "rel_table" else jnp.asarray(param),
                            jnp.arange(Sq), jnp.arange(Sk), B, hq, causal,
                            jpm)
    kr = jnp.repeat(jnp.asarray(k), hq // hk, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kr) * scale + bias
    s = jnp.where(bias > -5e29, s, -jnp.inf)
    return ref, np.asarray(jax.nn.logsumexp(s, axis=-1))


def _reference_grads(name, inputs, lse_j):
    """The reference's VJP of `flash_attention_biased` in q, k, v and the
    bias parameter. Its backward is NaN wherever a query row has no valid
    key (the VJP of o / max(l, 1e-30) divides by max(l, 1e-30)^2, which
    underflows to 0 in f32) and, through that row's dS, in dk of its
    batch. Such rows add nothing to any gradient, so for the "masked"
    cases the reference runs batch by batch without them (a batch with
    none left has zero gradients); those rows' dq is 0."""
    q, k, v, do, param, R, pm, scale = inputs
    B, Sq, Sk, hq, hk, d, kind, causal, chunk, special = BIASED_CASES[name]
    if special != "masked":
        ref, _ = _reference_biased(name, q, k, v, param, R, pm, scale)
        _, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (q, k, v, param)))
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]
    empty = np.isinf(lse_j)                              # [B, Hq, Sq]
    assert (empty == empty[:, :1]).all()                 # whole rows
    grads = [np.zeros_like(t) for t in (q, k, v, param)]
    for b in range(B):
        keep = np.flatnonzero(~empty[b, 0])
        if len(keep) == 0:
            continue
        # only a dense bias of a full (non-causal) problem may lose some
        # of its rows: row positions do not enter it
        assert len(keep) == Sq or (kind == "dense" and not causal)
        pb = param[b:b + 1] if kind == "dense" else param
        if kind == "dense" and pb.shape[2] != 1:
            pb = pb[:, :, keep]
        sub = (q[b:b + 1, keep], k[b:b + 1], v[b:b + 1], do[b:b + 1, keep],
               pb, R, None if pm is None else pm[b:b + 1], scale)
        ref, _ = _reference_biased(name, *sub[:3], *sub[4:])
        _, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in sub[:3] + (pb,)))
        gq, gk, gv, gp = (np.asarray(g) for g in vjp(jnp.asarray(sub[3])))
        grads[0][b, keep] = gq[0]
        grads[1][b], grads[2][b] = gk[0], gv[0]
        if kind == "dense" and param.shape[2] != 1:
            grads[3][b][:, keep] = gp[0]
        elif kind == "dense":
            grads[3][b] = gp[0]
        else:
            grads[3] += gp
    return grads


@pytest.mark.parametrize("name", list(BIASED_CASES))
def test_flash_attention_biased_matches_reference(name):
    """Output and grads (q, k, v and the bias parameters) against the
    reference's `flash_attention_biased` on the CPU (its jnp block
    stats), every row: the CPU route, and its two plain functions
    `_biased_plain_fwd` (o and the lse, against the reference's dense
    log-sum-exp) and `_biased_plain_bwd` (dq, dk, dv) called directly.
    Rows with no valid key give output 0 and dq 0 (`_reference_grads`:
    the reference's own backward is NaN there)."""
    B, Sq, Sk, hq, hk, d, kind, causal, chunk, special = BIASED_CASES[name]
    inputs = _biased_inputs(name)
    q, k, v, do, param, R, pm, scale = inputs
    ref, lse_j = _reference_biased(name, q, k, v, param, R, pm, scale)
    o_j = ref(*(jnp.asarray(t) for t in (q, k, v, param)))
    grads_j = _reference_grads(name, inputs, lse_j)
    tpm = None if pm is None else torch.from_numpy(pm)
    leaves = [_t(t, True) for t in (q, k, v, param)]
    o = t_fa.flash_attention_biased(
        *leaves[:3], kind, (leaves[3], R) if kind == "rel_table"
        else leaves[3], causal=causal, scale=scale, padding_mask=tpm,
        chunk=chunk)
    o.backward(_t(do))
    assert _max_rel(o.detach(), o_j) <= KERNEL_RTOL
    for got, want in zip((t.grad for t in leaves), grads_j):
        assert got.shape == tuple(want.shape)
        assert bool(torch.isfinite(got).all())
        assert _max_rel(got, want) <= KERNEL_RTOL

    args = (kind, _t(param), R if kind == "rel_table" else None, causal,
            scale, tpm, chunk)
    o_p, lse = t_fa._biased_plain_fwd(_t(q), _t(k), _t(v), *args)
    assert _max_rel(o_p, o_j) <= KERNEL_RTOL
    empty = np.isinf(lse_j)
    assert np.array_equal(np.isinf(lse.numpy()), empty)
    assert _max_rel(lse.numpy()[~empty], lse_j[~empty]) <= KERNEL_RTOL
    grads_p = t_fa._biased_plain_bwd(_t(q), _t(k), _t(v), o_p, lse, _t(do),
                                     *args)
    for got, want in zip(grads_p, grads_j[:3]):
        assert _max_rel(got, want) <= KERNEL_RTOL
    if special == "masked":
        rows = np.transpose(empty, (0, 2, 1))              # [B, Sq, Hq]
        assert rows[1].all()
        for t in (o_p, o.detach(), grads_p[0], leaves[0].grad):
            assert bool((t.numpy()[rows] == 0).all())


def _eval_bias_args(a, B, Hq, Sq, Sk, causal):
    """The kernels' `bias_head` / `bias_at` over every (b, h, i, j) of a
    `_bias_args` lowering, in plain torch with the kernels' index
    arithmetic (a dense bias read from its flat storage through the
    element strides). Returns (bias f32 [B, Hq, Sq, Sk], valid)."""
    b = torch.arange(B)[:, None, None, None]
    h = torch.arange(Hq)[None, :, None, None]
    i = torch.arange(Sq)[None, None, :, None]
    j = torch.arange(Sk)[None, None, None, :]
    flat = a.p.reshape(-1) if a.kind != 3 else torch.tensor(
        [], dtype=torch.float32).set_(a.p.untyped_storage())
    if a.kind == 1:
        d = (i - j).float()
        bv = -flat[h] * (d if causal else d.abs())
    elif a.kind == 2:
        bv = flat[h * (2 * a.R + 1) + (j - i).clamp(-a.R, a.R) + a.R]
    else:
        sb, sh, sq, sk = a.strides
        bv = flat[a.p.storage_offset() + b * sb + h * sh + i * sq + j * sk]
    valid = bv > -5e29
    if causal:
        valid = valid & (j <= i)
    if a.kv_valid is not None:
        valid = valid & a.kv_valid.bool()[:, None, None, :]
    return bv.expand(B, Hq, Sq, Sk), valid.expand(B, Hq, Sq, Sk)


@pytest.mark.parametrize("name", ["alibi_full_gqa", "alibi_causal_sq_lt_sk",
                                  "rel_table_full_gqa_pad",
                                  "dense_masked_rows_neg_inf",
                                  "sk_not_a_chunk_multiple"])
def test_bias_args_lowering_equals_bias_chunk(name):
    """`_bias_args` lowers each kind to what the kernels read; evaluated
    with the kernels' index arithmetic it gives `_bias_chunk`'s bias and
    mask over the whole [B, Hq, Sq, Sk]: the same valid entries and the
    same values there. A dense parameter passed as a strided view (a
    transposed slice) lowers without a copy."""
    B, Sq, Sk, hq, hk, d, kind, causal, chunk, special = BIASED_CASES[name]
    _, _, _, _, param, R, pm, _ = _biased_inputs(name)
    p = _t(param)
    if kind == "dense":
        p = _t(np.ascontiguousarray(np.swapaxes(param, 2, 3))
               ).transpose(2, 3)
    tpm = None if pm is None else torch.from_numpy(pm)
    a = t_fa._bias_args(kind, p, R if kind == "rel_table" else None, tpm,
                        (B, Sq, hq, d), (B, Sk, hk, d))
    if kind == "dense":
        assert a.p.data_ptr() == p.data_ptr()
    got, valid = _eval_bias_args(a, B, hq, Sq, Sk, causal)
    want = t_fa._bias_chunk(kind, (p, R) if kind == "rel_table" else p, Sq,
                            0, Sk, causal, None if tpm is None
                            else tpm.bool()).expand(B, hq, Sq, Sk)
    assert torch.equal(valid, want > -5e29)
    assert torch.equal(got[valid], want[valid])


def test_biased_route_holds_no_full_score_buffer():
    """The forward and the backward of the chunked route never allocate
    a [B, H, Sq, Sk] f32 tensor (the reference's HLO property,
    tests/test_flash_attention.py:365): every tensor the forward saves and
    every tensor created in the backward is recorded."""
    B, S, H, D, C = 1, 512, 2, 64, 128
    rng = np.random.default_rng(4)
    q, k, v = (_t(_rand(rng, B, S, H, D), True) for _ in range(3))
    slopes = torch.ones(H)
    full = B * H * S * S
    largest = []

    def pack(t):
        largest.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = t_fa.flash_attention_biased(q, k, v, "alibi", slopes, causal=True,
                                        scale=0.125, chunk=C)
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if torch.is_tensor(t):
                    largest.append(t.numel())
            return out

    with Sizes():
        o.float().sum().backward()
    assert max(largest) <= B * H * S * C < full


def test_bshd_bias_routes_to_the_biased_route():
    rng = np.random.default_rng(5)
    q = _t(_rand(rng, 1, 64, 2, 64))
    bias = _t(0.3 * _rand(rng, 1, 1, 64, 64))
    want = j_fa.flash_attention_bshd(jnp.asarray(q.numpy()),
                                     jnp.asarray(q.numpy()),
                                     jnp.asarray(q.numpy()),
                                     bias=jnp.asarray(bias.numpy()))
    got = t_fa.flash_attention_bshd(q, q, q, bias=bias)
    assert _max_rel(got, want) <= KERNEL_RTOL


# ---------------------------------------------------- nn.functional


def _sdpa_pair(q, k, v, do, mask_np, causal, valid_rows, ref_mask=None):
    """(max rel of out, of each grad) of the port's sdpa against the
    reference's on the same inputs; do is zeroed at rows that are not
    `valid_rows` ([B, Sq] bool) on both sides. ref_mask: the mask the
    reference gets, when its CPU route cannot broadcast mask_np (a
    [B, Sk] or [B, 1, Sk] padding mask, which its TPU route converts)."""
    do = do * valid_rows[:, :, None, None]
    jq, jk, jv = (paddle.to_tensor(t, stop_gradient=False)
                  for t in (q, k, v))
    if ref_mask is None:
        ref_mask = mask_np
    jmask = None if ref_mask is None else paddle.to_tensor(ref_mask)
    o_j = JF.scaled_dot_product_attention(jq, jk, jv, attn_mask=jmask,
                                          is_causal=causal)
    (o_j * paddle.to_tensor(do)).sum().backward()
    leaves = [_t(t, True) for t in (q, k, v)]
    tmask = None if mask_np is None else torch.from_numpy(mask_np)
    o = TF.scaled_dot_product_attention(*leaves, attn_mask=tmask,
                                        is_causal=causal)
    o.backward(_t(do))
    sel = valid_rows
    errs = [_max_rel(o.detach().numpy()[sel], o_j.numpy()[sel])]
    errs += [_max_rel(t.grad, jt.grad.numpy())
             for t, jt in zip(leaves, (jq, jk, jv))]
    return errs


SDPA_MASKS = ["none_full", "none_causal", "bool_kv", "bool_b_kv",
              "bool_b_1_kv", "bool_b_1_1_kv", "bool_b_1_1_kv_causal",
              "float_b_1_1_kv", "bool_per_query", "float_sq_sk",
              "cross_none", "cross_bool_b_kv"]


@pytest.mark.parametrize("which", SDPA_MASKS)
def test_sdpa_routes_match_reference(which):
    """Every route of scaled_dot_product_attention and every mask shape
    `_as_padding_mask` converts; float [B, 1, 1, Sk] takes the bias
    route. Every row compares, the padded query rows of a padding mask
    too (they attend to the valid keys on both sides)."""
    B, Sq, H, D = 2, 128, 2, 64
    Sk = 192 if which.startswith("cross") else Sq
    rng = np.random.default_rng(6)
    q, do = _rand(rng, B, Sq, H, D), _rand(rng, B, Sq, H, D)
    k, v = _rand(rng, B, Sk, H, D), _rand(rng, B, Sk, H, D)
    lengths = [Sk - 40, Sk - 3]
    pm = _lengths_mask(lengths, Sk)
    rows = np.ones((B, Sq), bool)
    causal = which in ("none_causal", "bool_b_1_1_kv_causal")
    mask = None
    if which == "bool_kv":
        mask = pm[0]
        pm = np.broadcast_to(pm[0], (B, Sk))
    elif which in ("bool_b_kv", "cross_bool_b_kv"):
        mask = pm
    elif which == "bool_b_1_kv":
        mask = pm[:, None, :]
    elif which in ("bool_b_1_1_kv", "bool_b_1_1_kv_causal"):
        mask = pm[:, None, None, :]
    elif which == "float_b_1_1_kv":
        mask = np.where(pm, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    elif which == "bool_per_query":
        mask = np.tril(np.ones((Sq, Sk), bool))[None, None] | \
            (rng.random((B, 1, Sq, Sk)) > 0.5)
    elif which == "float_sq_sk":
        mask = 0.3 * _rand(rng, Sq, Sk)
    ref_mask = None
    if which in ("bool_b_kv", "bool_b_1_kv", "cross_bool_b_kv"):
        ref_mask = pm[:, None, None, :]
    errs = _sdpa_pair(q, k, v, do, mask, causal, rows, ref_mask)
    assert max(errs) <= SURFACE_RTOL, errs


@pytest.mark.parametrize("which", ["none", "causal", "bool_b_1_1_kv",
                                   "bool_per_query_causal", "float_sq_sk"])
def test_sdpa_ref_matches_reference_dense_route(which):
    """The port's `_sdpa_ref` (the reference's dense CPU route, kept as
    its record) against the reference's on every row, and the port's
    kernel route against it on every row too."""
    B, S, H, D = 2, 128, 2, 64
    rng = np.random.default_rng(16)
    q, k, v = (_rand(rng, B, S, H, D) for _ in range(3))
    pm = _lengths_mask([S - 40, S - 3], S)
    causal = which in ("causal", "bool_per_query_causal")
    mask = {"none": None, "causal": None,
            "bool_b_1_1_kv": pm[:, None, None, :],
            "bool_per_query_causal": rng.random((B, 1, S, S)) > 0.5,
            "float_sq_sk": 0.3 * _rand(rng, S, S)}[which]
    if which == "bool_per_query_causal":
        mask[..., 0] = True                 # every row keeps a key
    scale = D ** -0.5
    want = np.asarray(j_attn._sdpa_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), 0.0, causal, scale))
    tq, tk, tv = (_t(t) for t in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = t_attn._sdpa_ref(tq, tk, tv, tmask, 0.0, causal, scale)
    assert _max_rel(got, want) <= KERNEL_RTOL
    routed = TF.scaled_dot_product_attention(tq, tk, tv, attn_mask=tmask,
                                             is_causal=causal)
    assert _max_rel(routed, got.numpy()) <= SURFACE_RTOL


def test_sdpa_route_selection(monkeypatch):
    """Boolean kv-only masks go to the padding route, anything else
    broadcastable to the bias route, as `_as_padding_mask` decides."""
    seen = []
    real = t_fa.flash_attention_bshd

    def spy(*a, **kw):
        seen.append(("pad" if kw.get("padding_mask") is not None else
                     "bias" if kw.get("bias") is not None else "none"))
        return real(*a, **kw)

    monkeypatch.setattr(t_fa, "flash_attention_bshd", spy)
    q = torch.zeros(2, 64, 2, 64)
    pm = torch.ones(2, 64, dtype=torch.bool)
    for mask, want in ((None, "none"), (pm, "pad"), (pm[:, None], "pad"),
                       (pm[:, None, None], "pad"), (pm[0], "pad"),
                       (pm[:, None, None].float(), "bias"),
                       (torch.ones(64, 64, dtype=torch.bool), "bias")):
        TF.scaled_dot_product_attention(q, q, q, attn_mask=mask)
        assert seen[-1] == want
    with pytest.raises(ValueError, match="does not broadcast"):
        TF.scaled_dot_product_attention(q, q, q,
                                        attn_mask=torch.ones(3, 64))


def test_sdpa_unported_knobs_raise():
    """What sdpa still refuses raises; dropout in training is ported
    (the reference's dense route with an output dropout,
    tests/test_torch_dropout.py holds it to the reference), so it runs."""
    q = torch.zeros(1, 64, 2, 64)
    out = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    assert out.shape == q.shape and torch.isfinite(out).all()
    out = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                          training=False)
    assert out.shape == q.shape
    with pytest.raises(NotImplementedError, match="causal"):
        TF.scaled_dot_product_attention(q, torch.zeros(1, 32, 2, 64),
                                        torch.zeros(1, 32, 2, 64),
                                        is_causal=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention_bshd(q, q, q, padding_mask=torch.ones(1, 64),
                                  use_kernel=True)


def test_flash_attention_functional():
    rng = np.random.default_rng(7)
    q = _rand(rng, 2, 64, 2, 64)
    out_j, _ = JF.flash_attention(paddle.to_tensor(q), paddle.to_tensor(q),
                                  paddle.to_tensor(q), causal=True)
    out, sm = TF.flash_attention(_t(q), _t(q), _t(q), causal=True)
    assert sm is None
    assert _max_rel(out, out_j.numpy()) <= SURFACE_RTOL


@pytest.mark.parametrize("cu", [[0, 1, 50, 50, 128], [0, 128],
                                [0, 3, 7, 8]])
def test_packed_segments_match_reference(cu):
    total = cu[-1]
    want = np.asarray(j_attn._packed_segments(jnp.asarray(cu), total))
    got = t_attn._packed_segments(torch.tensor(cu), total)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()


@pytest.mark.parametrize("hq,hk,causal", [(2, 2, True), (2, 2, False),
                                          (4, 2, True), (4, 1, False)],
                         ids=["mha_causal", "mha_full", "gqa_causal",
                              "mqa_full"])
def test_flash_attn_unpadded_matches_reference(hq, hk, causal):
    """Packed sequences of 7, 64, 1 and 56 tokens (and, not causal, kv
    packed as 20, 10, 30 and 40): output and grads against the
    reference's flash_attn_unpadded (its dense per-sequence route on
    the CPU)."""
    rng = np.random.default_rng(8)
    cq = np.array([0, 7, 71, 72, 128], np.int32)
    ck = cq if causal else np.array([0, 20, 30, 60, 100], np.int32)
    D = 64
    q, do = _rand(rng, cq[-1], hq, D), _rand(rng, cq[-1], hq, D)
    k, v = _rand(rng, ck[-1], hk, D), _rand(rng, ck[-1], hk, D)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv = (paddle.to_tensor(t, stop_gradient=False)
                  for t in (q, k, v))
    jcq = paddle.to_tensor(cq)
    jck = jcq if causal else paddle.to_tensor(ck)
    o_j, _ = JF.flash_attn_unpadded(jq, jk, jv, jcq, jck, 64, 64, scale,
                                    causal=causal)
    (o_j * paddle.to_tensor(do)).sum().backward()
    leaves = [_t(t, True) for t in (q, k, v)]
    tcq = torch.from_numpy(cq)
    tck = tcq if causal else torch.from_numpy(ck)
    o, _ = TF.flash_attn_unpadded(*leaves, tcq, tck, 64, 64, scale,
                                  causal=causal)
    o.backward(_t(do))
    assert _max_rel(o.detach(), o_j.numpy()) <= SURFACE_RTOL
    for t, jt in zip(leaves, (jq, jk, jv)):
        assert _max_rel(t.grad, jt.grad.numpy()) <= SURFACE_RTOL


def test_flash_attn_unpadded_refusals():
    """Nothing is refused any more. Causal over packings that differ
    takes the reference's dense packed route: output and grads equal the
    reference's on the same call. Dropout in training is ported (the
    reference's dense packed route, which applies no dropout:
    tests/test_torch_dropout.py), so it runs and equals the call without
    dropout."""
    rng = np.random.default_rng(12)
    x, do = _rand(rng, 10, 2, 64), _rand(rng, 10, 2, 64)
    cq, ck = np.array([0, 5, 10], np.int32), np.array([0, 3, 10], np.int32)
    jx = [paddle.to_tensor(x, stop_gradient=False) for _ in range(3)]
    o_j, _ = JF.flash_attn_unpadded(*jx, paddle.to_tensor(cq),
                                    paddle.to_tensor(ck), 5, 7, 0.1,
                                    causal=True)
    (o_j * paddle.to_tensor(do)).sum().backward()
    leaves = [_t(x, True) for _ in range(3)]
    o, _ = TF.flash_attn_unpadded(*leaves, torch.from_numpy(cq),
                                  torch.from_numpy(ck), 5, 7, 0.1,
                                  causal=True)
    o.backward(_t(do))
    assert _max_rel(o.detach(), o_j.numpy()) <= SURFACE_RTOL
    for t, jt in zip(leaves, jx):
        assert _max_rel(t.grad, jt.grad.numpy()) <= SURFACE_RTOL
    y = torch.randn(10, 2, 64, generator=torch.Generator().manual_seed(0))
    cu = torch.tensor([0, 4, 10])
    out, _ = TF.flash_attn_unpadded(y, y, y, cu, cu, 6, 6, 0.1,
                                    dropout=0.1)
    want, _ = TF.flash_attn_unpadded(y, y, y, cu, cu, 6, 6, 0.1)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def test_sdp_kernel_is_a_no_op():
    with TF.sdp_kernel(enable_math=False) as ctx:
        assert ctx is not None


# ------------------------------------------------- MultiHeadAttention


def _mha_pair(embed=128, heads=2, seed=9):
    paddle.seed(seed)
    jm = JMHA(embed, heads)
    jm.eval()
    tm = TMHA(embed, heads, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v.numpy()))
                        for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("mask_kind", ["none", "padding", "float"])
def test_multi_head_attention_matches_reference(mask_kind):
    jm, tm = _mha_pair()
    rng = np.random.default_rng(10)
    B, S = 2, 64
    x = _rand(rng, B, S, 128)
    pm = _lengths_mask([S - 20, S], S)
    mask = None
    if mask_kind == "padding":
        mask = pm[:, None, None, :]
    elif mask_kind == "float":
        mask = np.where(pm, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    want = jm(paddle.to_tensor(x),
              attn_mask=None if mask is None else paddle.to_tensor(mask))
    with torch.no_grad():
        got = tm(_t(x), attn_mask=None if mask is None
                 else torch.from_numpy(mask))
    assert _max_rel(got, want.numpy()) <= SURFACE_RTOL


def test_multi_head_attention_caches():
    """`Cache` grows by each step's keys (a decode step of one query
    against the cache: q and kv lengths differ); `StaticCache` holds the
    encoder K/V once and ignores key/value."""
    jm, tm = _mha_pair()
    rng = np.random.default_rng(11)
    B = 2
    x0, x1, x2 = (_rand(rng, B, n, 128) for n in (5, 1, 1))
    mem = _rand(rng, B, 12, 128)
    jc = jm.gen_cache(paddle.to_tensor(x0))
    tc = tm.gen_cache(_t(x0))
    assert tuple(tc.k.shape) == (B, 0, 2, 64)
    with torch.no_grad():
        for x in (x0, x1, x2):
            want, jc = jm(paddle.to_tensor(x), cache=jc)
            got, tc = tm(_t(x), cache=tc)
            assert _max_rel(got.numpy(), want.numpy()) <= SURFACE_RTOL
        assert tuple(tc.k.shape) == (B, 7, 2, 64)
        jsc = jm.gen_cache(paddle.to_tensor(mem), type=JMHA.StaticCache)
        tsc = tm.gen_cache(_t(mem), type=TMHA.StaticCache)
        want, jsc2 = jm(paddle.to_tensor(x1), paddle.to_tensor(x1),
                        paddle.to_tensor(x1), cache=jsc)
        got, tsc2 = tm(_t(x1), _t(x1), _t(x1), cache=tsc)
        assert tsc2 is tsc
        assert _max_rel(got.numpy(), want.numpy()) <= SURFACE_RTOL
        wrapped = tm.gen_cache(tc.k, tc.v)
        assert wrapped.k is tc.k
