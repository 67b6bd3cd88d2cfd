"""The element limits that hold the port's kernels against their plain
PyTorch versions: one rule, shared by chip_smoke.py and the card tests.

The plain version runs on f32 copies of the kernel's inputs and keeps
its f32 result. An output element passes when

    |kernel - plain| <= atol + rtol * |plain|

(`worst` returns the largest ratio of the two sides; a non-finite kernel
value is a miss). A bf16 kernel that keeps f32 inside and rounds its
result once gets rtol = BF16_RTOL (two roundoffs of 2^-8) and a small
absolute atol for the f32 summation order near zero.

A kernel that rounds an intermediate to the input dtype before a second
product (flash attention's P and dS, the SwiGLU backward's dg and du)
can miss by a roundoff of each term of its sum, not of the sum. Its atol
is element by element: TERM_FRAC[dtype] times that element's own sum of
|terms|, which `flash_terms` and `swiglu_bwd_terms` compute on the plain
side. A limit scaled by the largest |plain| of the whole tensor would be
as large as a typical element of causal attention (the first rows and
keys dominate the maximum) and would pass a kernel that drops or adds a
tile of terms.

The segment-id flash kernels follow the flash rule (`seg_flash_terms`:
the terms over the pairs the segments and the causal mask leave), and so
do the bias kernels (`bias_flash_terms`: the terms of P from the biased
scores, over the entries the bias and the masks leave). The
block-stats kernel (row 8) rounds P to the input dtype before P V, so
its o takes the terms rule (its terms are P |V|, unnormalised); its m
is a maximum of f32 scores and its l a sum of unrounded f32 exponentials
(`STATS_LIMITS`: the scores' and the sum's f32 summation order). A score
x = s * scale + bias carries an f32 rounding of about 2^-24 |x| (the
kernel rounds the product and the sum once, in a fused multiply-add;
the plain version twice), so each exp(x - m) is off by up to about
2^-23 (|x| + |m|) relative, with x near m: l and o also get an atol of
STATS_M_FRAC (1 + |m|) times their own value (their terms, for o). A
bias far below zero, as alibi gives a row far from the chunk (|m| near
1000), makes that the larger part.

The W8A16 kernel (row 14, `kernels/weight_only_linear.py`) dequantizes
its int8 operand to exactly the plain version's bf16 weight and keeps
f32 accumulators: its output differs from the plain version's f32
product by the one rounding and the summation order (`W8A16_LIMIT`);
with a bias, the kernel rounds the product before the add, as PyTorch
does, so the plain side rounds it too and the atol takes a roundoff of
the product (`w8a16_pair`).

The fused cross-entropy kernels keep f32 throughout. The forward's f32
outputs differ from the plain version by summation order and the fast
exponential alone (`CE_LIMITS`: the row max m is exact, the sum-exp l
and the loss agree to a few f32 ulps of a 32000-term sum); the
backward's dx is rounded once to the logits' dtype, and its atol is
CE_DX_FRAC of its row's |g| (the scale of the row's dx: |p - onehot|
<= 1).
"""
from __future__ import annotations

import math

import torch

__all__ = ["BF16_RTOL", "TERM_FRAC", "worst", "flash_terms",
           "flash_pairs", "flash_readings", "DELTA_FRAC", "delta_pair",
           "swiglu_bwd_terms",
           "swiglu_bwd_pairs", "paged_decode_case", "paged_decode_views_case",
           "PAGED_DECODE_CASES", "paged_decode_cases", "paged_decode_pair",
           "paged_decode_readings", "RAGGED_CASES", "ragged_case",
           "ragged_cases", "ragged_pair", "verify_bitwise",
           "paged_split_readings",
           "CE_LIMITS", "CE_DX_FRAC",
           "fused_ce_case", "fused_ce_pairs", "FUSED_CE_CASES",
           "fused_ce_readings", "train_launches", "train_counters",
           "seg_flash_terms", "seg_flash_pairs", "seg_flash_readings",
           "SEG_FWD_TILES", "SEG_BWD_TILES", "VISIT_TILES",
           "seg_visit_plan", "seg_dkv_visit_plan", "seg_plan_attention",
           "seg_plan_keep", "seg_plan_grads", "tf32_round", "tf32_split",
           "VT_KEY_ORDER", "vt_positions",
           "STATS_LIMITS", "STATS_M_FRAC", "block_stats_pairs",
           "block_stats_readings",
           "bert_lengths", "packed_lengths", "ATTN_SEG_CASES",
           "attn_seg_case",
           "STATS_CASES", "stats_case", "BIAS_CASES", "alibi_slopes",
           "bias_case", "bias_flash_terms", "bias_flash_pairs",
           "bias_flash_readings", "attention_counters",
           "SURFACE_RTOL", "BERT_SEQ_ATOL", "BERT_SEQ_MEAN_ATOL",
           "BERT_LOGIT_ATOL", "BERT_LOGIT_MEAN_ATOL", "DROPOUT_SIGMAS",
           "keep_share_sigmas", "ENCODER_LOSS_RTOL", "ENCODER_GRAD_RTOL",
           "BERT_TRAIN_LOSS_RTOL", "BERT_TRAIN_GRAD_RTOL",
           "encoder_counters", "encoder_launches", "OPT_CARD_RTOL",
           "OPT_LBFGS_RTOL", "ACCUM_LOSS_RTOL", "ACCUM_WEIGHT_RL2",
           "opt_card_cases", "max_rel", "W8A16_LIMIT", "W8A16_SHAPES",
           "W8A16_ROWS", "W8A16_LAYOUTS", "W8A16_SWITCH_ROWS", "w8a16_case",
           "w8a16_pair", "w8a16_switch_rows", "w8a16_rows_independent", "INT8_GAP_LIMIT", "int8_step_launches",
           "top2_gap"]

BF16_RTOL = 2.0 ** -7
# share of an element's sum of |terms|: two bf16 roundoffs (the rounded
# intermediate and the rounded result); f32 runs no rounded intermediate,
# its share covers the summation order alone
TERM_FRAC = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


def worst(out, ref, atol, rtol) -> float:
    """max |out - ref| / (atol + rtol * |ref|) over the elements; atol is
    a number or a tensor shaped like ref. inf when out holds a non-finite
    value."""
    out = out.double()
    ref = ref.double()
    if not bool(torch.isfinite(out).all()):
        return math.inf
    atol = atol.double() if torch.is_tensor(atol) else atol
    err = (out - ref).abs()
    # an exact match passes any limit, a zero one included (0 / 0)
    return torch.where(err == 0, 0.0,
                       err / (atol + rtol * ref.abs())).max().item()


def _group_sum(t, group):
    """[B, Hq, S, D] -> [B, Hq / group, S, D], summing each kv head's
    group of q heads."""
    if group == 1:
        return t
    B, H, S, D = t.shape
    return t.view(B, H // group, group, S, D).sum(2)


def flash_terms(q, k, v, do, causal, scale=None):
    """f32 sums of |terms| of flash attention's outputs, BSHD like them:
    (o, dq, dk, dv). q, k, v, do are the plain side's f32 copies, GQA
    kv heads not repeated; scale multiplies the scores (None: 1/sqrt(D)).

    o_i = sum_j P_ij v_j, so its terms are P |V|. dS_ij = P_ij (dP_ij -
    D_i) with D_i = sum_d dO_id O_id, so dS's terms are P (|dP| + sum_d
    |dO O|); dq's are |dS| |K| |scale|, dk's |dS|^T |Q| |scale|, dv's
    P^T |dO|, dk and dv summed over a kv head's group of q heads."""
    from .kernels import flash_attention as kfa
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[2] // k.shape[2]
    p = torch.softmax(kfa._scores(q, k, causal, scale), dim=-1)
    qh, kh, vh, doh = (t.transpose(1, 2).float() for t in (q, k, v, do))
    if group > 1:
        kh, vh = (t.repeat_interleave(group, dim=1) for t in (kh, vh))
    o = p @ vh
    o_t = p @ vh.abs()
    d_abs = (doh.abs() * o.abs()).sum(-1, keepdim=True)
    ds_t = p * ((doh @ vh.transpose(-1, -2)).abs() + d_abs)
    del o, d_abs
    dq_t = (ds_t @ kh.abs()) * abs(scale)
    dk_t = _group_sum(ds_t.transpose(-1, -2) @ qh.abs(), group) * abs(scale)
    dv_t = _group_sum(p.transpose(-1, -2) @ doh.abs(), group)
    return tuple(t.transpose(1, 2) for t in (o_t, dq_t, dk_t, dv_t))


def flash_pairs(q, k, v, do, causal, scale):
    """The flash kernels (`flash_attention_fwd`, `flash_attention_bwd`)
    and their plain version on the same inputs: q, k, v, do BSHD in one
    dtype; GQA callers pass q pre-scaled in its dtype and scale 1, as
    `flash_attention_bshd` does. Returns ([(label, kernel, plain, terms
    or None)] for o, lse, dq, dk, dv; the kernel's (o, lse))."""
    from .kernels import flash_attention as kfa
    o, lse = kfa.flash_attention_fwd(q, k, v, causal, scale)
    dq, dk, dv = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o_p = kfa._plain(*ref, causal, scale)
        o_p.backward(do.float())
    plain = [t.detach() for t in ref]
    lse_p = kfa._plain_lse(plain[0], plain[1], causal, scale)
    o_t, dq_t, dk_t, dv_t = flash_terms(*plain, do.float(), causal, scale)
    return ([("o", o, o_p.detach(), o_t), ("lse", lse, lse_p, None),
             ("dq", dq, ref[0].grad, dq_t), ("dk", dk, ref[1].grad, dk_t),
             ("dv", dv, ref[2].grad, dv_t)], (o, lse))


# The delta pre-pass, D = rowsum(dO * O) over D products of bf16
# inputs: each product is exact in f32 and the f32 sum in any order is
# within (D - 1) 2^-24 of its sum of |terms| (7.6e-6 at D = 128); the
# limit is twice that bound, element by element.
DELTA_FRAC = 2.0 ** -16


def delta_pair(o, do):
    """The delta pre-pass (`flash_attention_delta`) and its plain version
    on o, do BSHD: (label, kernel, plain, atol, rtol) with atol
    DELTA_FRAC of each element's sum of |dO O| terms."""
    from .kernels import flash_attention as kfa
    got = kfa.flash_attention_delta(o, do)
    prod = do.float() * o.float()
    ref = prod.sum(-1).transpose(1, 2)
    terms = prod.abs().sum(-1).transpose(1, 2)
    return ("delta", got, ref, DELTA_FRAC * terms, 0.0)


def flash_readings(B=4, S=2048, H=16, D=128, causal=True, seed=0):
    """bf16 MHA flash at the training slice's shape on the card: for each
    output, the worst err/limit under the element limit (`terms`: atol =
    2^-7 of the element's sum of |terms|; lse: 1e-4 + 1e-5 |plain|;
    delta, the backward's pre-pass: `delta_pair`) and, beside it, under a
    limit scaled by the tensor's max |plain| (`max`: atol = 2^-7
    max|plain|), both with rtol 2^-7. A reading above 1 is a miss."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    pairs, (o, _) = flash_pairs(q, k, v, do, causal, 1.0 / math.sqrt(D))
    frac = TERM_FRAC[torch.bfloat16]
    _, got, ref, atol, rtol = delta_pair(o, do)
    out = {"delta": {"terms": worst(got, ref, atol, rtol)}}
    for label, got, ref, terms in pairs:
        if terms is None:
            out[label] = {"terms": worst(got, ref, 1e-4, 1e-5)}
            continue
        out[label] = {
            "terms": worst(got, ref, frac * terms, BF16_RTOL),
            "max": worst(got, ref, frac * ref.abs().max().item(), BF16_RTOL)}
    return out


def swiglu_bwd_terms(a, w_gate_up, do):
    """f32 sums of |terms| of the SwiGLU backward's outputs (da, dw) from
    the plain side's f32 copies: dgu = [dg | du] is formed in f32 and
    rounded before both products, da = dgu w_gate_up^T and dw = a^T dgu,
    so the terms are |dgu| |w_gate_up|^T and |a|^T |dgu|."""
    import torch.nn.functional as F
    m = w_gate_up.shape[-1] // 2
    a2 = a.reshape(-1, a.shape[-1]).float()
    with torch.enable_grad():
        gu = (a2 @ w_gate_up.float()).requires_grad_()
        y = F.silu(gu[:, :m]) * gu[:, m:]
        (dgu,) = torch.autograd.grad(y, gu, do.reshape(-1, m).float())
    dgu = dgu.abs()
    return ((dgu @ w_gate_up.float().abs().T).reshape(a.shape),
            a2.abs().T @ dgu)


def swiglu_bwd_pairs(a, w_gate_up, do):
    """The SwiGLU backward kernels (`swiglu_bwd_da`, `swiglu_bwd_dw`) and
    their plain version on the same inputs. Returns ([(label, kernel,
    plain, terms)] for da and dw; the kernel's dgu)."""
    from .kernels import swiglu as ksw
    da, dgu = ksw.swiglu_bwd_da(a, w_gate_up, do)
    dw = ksw.swiglu_bwd_dw(a, dgu)
    da_p, dw_p = ksw._ref_bwd(a.float(), w_gate_up.float(), do.float())
    da_t, dw_t = swiglu_bwd_terms(a, w_gate_up, do)
    return [("da", da, da_p, da_t), ("dw", dw, dw_p, dw_t)], dgu


def paged_decode_case(lengths=(17, 100, 300, 700), nh=32, kvh=32, d=128,
                      page=16, ppseq=64, dtype=torch.bfloat16, seed=0):
    """Paged decode attention inputs on the card, by default the bucketed
    engine's llama_7b decode: q [B, nh, d] and a pool [kvh, B*ppseq + 1,
    page, d] of random values with a shuffled block table [B, ppseq]
    (sequence b owns ceil(lengths[b] / page) distinct pages in random
    order; page 0 is never used, as the engine's scratch page). Returns
    (q, k_pages, v_pages, lengths, page_indices)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lengths)
    n_pages = B * ppseq + 1

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, kp, vp = rand(B, nh, d), rand(kvh, n_pages, page, d), \
        rand(kvh, n_pages, page, d)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).to(torch.int32)
    pt = torch.zeros((B, ppseq), dtype=torch.int32, device="cuda")
    nxt = 0
    for b, n in enumerate(lengths):
        used = -(-n // page)
        pt[b, :used] = perm[nxt:nxt + used]
        nxt += used
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, lens, pt


def paged_decode_views_case(S, lengths, layers=1, nh=32, kvh=32, d=128,
                            dtype=torch.bfloat16, seed=0):
    """Paged decode attention inputs as `generate` reads its cache on the
    card: a contiguous cache [layers, B, S, kvh, d] of random values seen
    through `paginate_cache`'s page views (strided, no copy) and the
    identity block table; the last layer's views are returned, an offset
    slice as every layer's but the first. Returns (q, k_pages, v_pages,
    lengths, page_indices)."""
    from .kernels import paged_attention as kpa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lengths)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ck, cv = rand(layers, B, S, kvh, d), rand(layers, B, S, kvh, d)
    kp, vp, pt = kpa.paginate_cache(ck, cv)
    q = rand(B, nh, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp[-1], vp[-1], lens, pt


# The paged decode cases the card checks, in chip_smoke.py and in the
# card tests: tag -> (builder, kwargs). "engine" is the bucketed engine's
# llama_7b decode; "generate_cache" is generate's own in chip_smoke.py
# (a page-rounded 128 + 64 = 192-token cache, lengths over its decode
# steps' range 129..191, layer 1 of 2); "generate_views" a 1024-token
# cache read through the same views; then GQA 32/8, d = 64 with GQA 8/2
# and pages of 8, and one sequence.
PAGED_DECODE_CASES = {
    "engine": (paged_decode_case, {}),
    "generate_cache": (paged_decode_views_case,
                       dict(S=192, lengths=(129, 150, 177, 191), layers=2)),
    "generate_views": (paged_decode_views_case,
                       dict(S=1024, lengths=(1, 129, 700, 1024))),
    "gqa_32_8": (paged_decode_case, dict(kvh=8)),
    "d64_gqa_8_2_page8": (paged_decode_case,
                          dict(nh=8, kvh=2, d=64, page=8, ppseq=32,
                               lengths=(1, 255, 256))),
    "b1": (paged_decode_case, dict(lengths=(1000,))),
}


def paged_decode_cases(dtype, tags=None, seed=0):
    """Yields (tag, (q, k_pages, v_pages, lengths, page_indices)) for
    each tag of `PAGED_DECODE_CASES` (all by default), one case built at
    a time."""
    for tag in tags or PAGED_DECODE_CASES:
        make, kw = PAGED_DECODE_CASES[tag]
        yield tag, make(dtype=dtype, seed=seed, **kw)


def paged_decode_pair(q, k_pages, v_pages, lengths, page_indices):
    """The paged decode kernel and its plain version on f32 copies of
    the same inputs; the plain side keeps the one low-precision step of
    its float order, q pre-scaled in q's dtype. Returns (kernel, plain)."""
    from .kernels import paged_attention as kpa
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = kpa.paged_decode_attention(q, k_pages, v_pages, lengths,
                                     page_indices, use_kernel=True)
    ref = kpa._dense_fallback((q * scale).float(), k_pages.float(),
                              v_pages.float(), lengths, page_indices)
    return out, ref


def paged_decode_readings(seed=0):
    """bf16 paged decode at the bucketed engine's shape on the card: the
    worst err/limit of the output under atol 1e-5 + 2^-7 |plain| (a
    reading above 1 is a miss)."""
    out, ref = paged_decode_pair(*paged_decode_case(seed=seed))
    return {"o": worst(out, ref, 1e-5, BF16_RTOL)}


def ragged_case(rows, T=128, nh=32, kvh=32, d=128, page=16, ppmax=64,
                dtype=torch.bfloat16, seed=0, views=False):
    """Ragged paged attention inputs on the card, by default at the
    serving step's llama_7b shapes: q [T, nh, d], a pool [kvh, B*ppmax +
    1, page, d] of random values (or, with views, `paginate_cache`'s
    strided views of a contiguous [B, ppmax * page, kvh, d] cache, read
    in place), per-slot (q_start, q_len, kv_len) from `rows` and a block
    table giving slot s ceil(kv_len / page) distinct pages in random
    order (page 0 never used, as the engine's scratch page). Returns
    (q, k_pages, v_pages, q_start, q_len, kv_len, page_table)."""
    from .kernels import paged_attention as kpa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = len(rows)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q = rand(T, nh, d)
    if views:
        kp, vp, pt = kpa.paginate_cache(rand(B, ppmax * page, kvh, d),
                                        rand(B, ppmax * page, kvh, d),
                                        page)
    else:
        n_pages = B * ppmax + 1
        kp, vp = rand(kvh, n_pages, page, d), rand(kvh, n_pages, page, d)
        perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                + 1).to(torch.int32)
        pt = torch.zeros((B, ppmax), dtype=torch.int32, device="cuda")
        nxt = 0
        for s, (_, _, kl) in enumerate(rows):
            n = -(-kl // page)
            pt[s, :n] = perm[nxt:nxt + n]
            nxt += n
    meta = [torch.tensor([r[i] for r in rows], dtype=torch.int32,
                         device="cuda") for i in range(3)]
    return (q, kp, vp, *meta, pt)


# The ragged paged attention cases the card checks: tag -> ragged_case's
# kwargs. "mixed" and "decode_only" are chip_smoke.py's (its RAGGED_ROWS:
# a 60-row chunk deep in a 700-token prompt, a decode row at 300, an idle
# slot, a fresh 64-token prefill and 3 padding rows; the burst's steady
# state of four decode rows at 18/101/301/701 keys); then GQA 32/8, d =
# 64 with GQA 8/2 and pages of 8 (a chunk whose packed rows fill two
# tensor tiles, decode rows, a short chunk on the walk), and the
# "mixed" rows read through paginate_cache's strided views. "verify" is
# chip_smoke.py's speculative verify step (four entries of a decode row
# and 4 drafts at 22/105/305/705 keys) and "verify_gqa_32_8" verify
# entries of 9, 5, 2 and 1 rows under GQA 32/8 (36 and 20 packed rows,
# which an unflagged launch puts on tensor tiles); the engine launches
# both with every entry flagged in `row_tiles`.
RAGGED_CASES = {
    "mixed": dict(rows=[(0, 60, 700), (60, 1, 300), (0, 0, 0),
                        (61, 64, 64)]),
    "decode_only": dict(rows=[(0, 1, 18), (1, 1, 101), (2, 1, 301),
                              (3, 1, 701)]),
    "verify": dict(rows=[(0, 5, 22), (5, 5, 105), (10, 5, 305),
                         (15, 5, 705)]),
    "verify_gqa_32_8": dict(rows=[(0, 9, 300), (9, 5, 64), (14, 2, 700),
                                  (16, 1, 33)], kvh=8),
    "gqa_32_8": dict(rows=[(0, 60, 700), (60, 1, 300), (0, 0, 0),
                           (61, 64, 64)], kvh=8),
    "d64_gqa_8_2_page8": dict(rows=[(0, 33, 400), (33, 1, 1), (34, 1, 257),
                                    (35, 2, 70), (0, 0, 0)],
                              T=40, nh=8, kvh=2, d=64, page=8),
    "views": dict(rows=[(0, 60, 700), (60, 1, 300), (0, 0, 0),
                        (61, 64, 64)], views=True, ppmax=48),
}


def ragged_cases(dtype, tags=None, seed=0):
    """Yields (tag, ragged_case(...)) for each tag of `RAGGED_CASES` (all
    by default), one case built at a time."""
    for tag in tags or RAGGED_CASES:
        yield tag, ragged_case(dtype=dtype, seed=seed, **RAGGED_CASES[tag])


def ragged_pair(q, k_pages, v_pages, q_start, q_len, kv_len, page_table):
    """The ragged paged attention kernel and its plain version on f32
    copies of the same inputs (q pre-scaled in q's dtype, the plain
    side's one low-precision step). Returns (kernel, plain)."""
    from .kernels import ragged_paged_attention as krpa
    scale = 1.0 / math.sqrt(q.shape[-1])
    meta = (q_start, q_len, kv_len, page_table)
    out = krpa.ragged_paged_attention(q, k_pages, v_pages, *meta,
                                      use_kernel=True)
    ref = krpa._dense_fallback((q * scale).float(), k_pages.float(),
                               v_pages.float(), *meta, 1.0)
    return out, ref


def verify_bitwise(fn, args, row_tiles=None):
    """(rows equal, rows): the rows of ragged_case's packed entries, fn
    called with `row_tiles`, that equal under torch.equal the same row
    sent alone as a q_len = 1 decode row at its own kv length (fn
    without row tiles, the non-speculative engine's call) over the same
    pool. Row j of every entry goes in one call, entries of j rows or
    fewer idle."""
    q, kp, vp, q_start, q_len, kv_len, pt = args
    kw = {} if row_tiles is None else {"row_tiles": row_tiles}
    out = fn(q, kp, vp, q_start, q_len, kv_len, pt, **kw)
    zero = torch.zeros_like(q_start)
    same = n = 0
    for j in range(int(q_len.max())):
        live = q_len > j
        dec = fn(q, kp, vp, torch.where(live, q_start + j, zero),
                 live.to(q_len.dtype),
                 torch.where(live, kv_len - q_len + j + 1, zero), pt)
        for s in range(q_start.shape[0]):
            if int(q_len[s]) > j:
                t = int(q_start[s]) + j
                same += bool(torch.equal(out[t], dec[t]))
                n += 1
    return same, n


# Non-finite values in the page pool (the serving SLO layer's non-finite
# isolation): (q_start, q_len, kv_len) of the ragged case, a decode row
# of one split, one of three, a 12-row chunk (bf16: a tensor-core tile)
# and a 5-row chunk on the walk; the decode case's lengths.
NONFINITE_RAGGED_ROWS = ((0, 1, 40), (1, 1, 600), (2, 12, 300),
                         (14, 5, 20))
NONFINITE_PAGED_LENS = (40, 600, 300)


def _nonfinite_pages(lens, page):
    """A page table giving each sequence its own pages (page 0 is the
    scratch page, one page stays unallocated) and the pool's page count."""
    ppmax = max(-(-n // page) for n in lens) + 1
    pt = torch.zeros(len(lens), ppmax, dtype=torch.int32)
    nxt = 1
    for s, n in enumerate(lens):
        k = -(-n // page)
        pt[s, :k] = torch.arange(nxt, nxt + k, dtype=torch.int32)
        nxt += k
    return pt, nxt + 1


def nonfinite_checks(rpa, pa, dtype, device, nh=8, kvh=2, d=128, page=16,
                     seed=0):
    """[(label, ok)]: the NaN semantics of `rpa.ragged_paged_attention`
    (row 9) and `pa.paged_decode_attention` (row 13) on `device` (the
    kernels on the card, the plain routes on the CPU). Stale values past
    each sequence's length in its pages, in the scratch page and in an
    unallocated page (NaN keys, inf values) must not reach the output:
    torch.equal to the clean pool's. A NaN key at position 0 of sequence
    s (seen by every row of s) makes every row of s NaN and leaves the
    other sequences' rows torch.equal to the clean output."""
    g = torch.Generator().manual_seed(seed)
    out = []

    def pools(n_pages):
        return (torch.randn(kvh, n_pages, page, d, generator=g),
                torch.randn(kvh, n_pages, page, d, generator=g))

    def stale(kp, vp, pt, lens):
        held = torch.zeros(kp.shape[1], page, dtype=torch.bool)
        for s, n in enumerate(lens):
            pos = torch.arange(n)
            held[pt[s, pos // page].long(), pos % page] = True
        k, v = kp.clone(), vp.clone()
        k[:, ~held] = float("nan")
        v[:, ~held] = float("inf")
        return k, v

    def on(*ts):
        return [t.to(device) for t in ts]

    def check_route(name, call, kp, vp, pt, lens, rows_of):
        clean = call(kp, vp)
        got = call(*stale(kp, vp, pt, lens))
        out.append((f"{name}: stale non-finite values past the lengths",
                    bool(torch.equal(got, clean))))
        for s in range(len(lens)):
            k = kp.clone()
            k[:, int(pt[s, 0]), 0] = float("nan")
            got = call(k, vp)
            mine = rows_of(s)
            rest = torch.ones(got.shape[0], dtype=torch.bool)
            rest[mine] = False
            ok = (bool(torch.isnan(got[mine]).all())
                  and bool(torch.equal(got[rest], clean[rest])))
            out.append((f"{name}: a NaN key of sequence {s} (kv_len "
                        f"{lens[s]}) reaches its rows alone", ok))

    rows = NONFINITE_RAGGED_ROWS
    lens = [r[2] for r in rows]
    pt, n_pages = _nonfinite_pages(lens, page)
    kp, vp = pools(n_pages)
    T = 32
    q = torch.randn(T, nh, d, generator=g)
    qs, ql, kl = (torch.tensor([r[i] for r in rows], dtype=torch.int32)
                  for i in range(3))

    def ragged(k, v):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        return rpa.ragged_paged_attention(
            *on(qq, kk, vv, qs, ql, kl, pt)).float().cpu()

    check_route(f"ragged_paged_attention {dtype}", ragged, kp, vp, pt,
                lens, lambda s: torch.arange(rows[s][0],
                                             rows[s][0] + rows[s][1]))
    lens = list(NONFINITE_PAGED_LENS)
    pt, n_pages = _nonfinite_pages(lens, page)
    kp, vp = pools(n_pages)
    qd = torch.randn(len(lens), nh, d, generator=g)
    ln = torch.tensor(lens, dtype=torch.int32)

    def paged(k, v):
        qq, kk, vv = (t.to(dtype) for t in (qd, k, v))
        return pa.paged_decode_attention(
            *on(qq, kk, vv, ln, pt)).float().cpu()

    check_route(f"paged_decode_attention {dtype}", paged, kp, vp, pt, lens,
                lambda s: torch.tensor([s]))
    return out


def paged_split_readings(seed=0):
    """bf16 split-KV checks on the card, each the worst err/limit under
    atol 1e-5 + 2^-7 |plain| (a reading above 1 is a miss): paged decode
    at the bucketed engine's case (700 keys: six splits), ragged paged
    attention at the serving step's mixed case (a tensor tile of three
    splits, a decode row of three) and at the decode-only case."""
    out, ref = paged_decode_pair(*paged_decode_case(seed=seed))
    readings = {"decode": worst(out, ref, 1e-5, BF16_RTOL)}
    for tag in ("mixed", "decode_only"):
        ((_, args),) = ragged_cases(torch.bfloat16, tags=(tag,), seed=seed)
        out, ref = ragged_pair(*args)
        readings[f"ragged_{tag}"] = worst(out, ref, 1e-5, BF16_RTOL)
    return readings


# fused cross-entropy forward outputs, f32 from either logits dtype:
# name -> (atol, rtol)
CE_LIMITS = {"loss": (1e-5, 2e-6), "m": (1e-6, 0.0), "l": (0.0, 1e-5)}
# the backward's dx: atol = CE_DX_FRAC * |g| of the row; rtol one
# rounding to bf16, or the f32 exponential's error
CE_DX_FRAC = 1e-5
CE_DX_RTOL = {torch.bfloat16: BF16_RTOL, torch.float32: 1e-5}


def fused_ce_case(N=8188, V=32000, dtype=torch.bfloat16, seed=0,
                  ignore_index=-100):
    """Fused cross-entropy inputs on the card, by default the training
    slice's [4 x 2047, 32000]: logits N(0, 2^2) in `dtype`, int64 labels
    uniform over the vocabulary with every 16th row ignore_index, one
    label past the vocabulary and one negative label that is not
    ignore_index, and a per-row cotangent g ~ N(0, 1) / N. Returns
    (logits, labels, g)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (2.0 * torch.randn((N, V), generator=gen,
                                device="cuda")).to(dtype)
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda")
    labels[::16] = ignore_index
    labels[1] = V + 5
    labels[2] = -7
    g = torch.randn((N,), generator=gen, device="cuda") / N
    return logits, labels, g


def fused_ce_pairs(logits, labels, g, ignore_index=-100):
    """The fused cross-entropy kernels and their plain version on f32
    copies of the same inputs. Returns ([(label, kernel, plain, atol,
    rtol)] for loss, m, l and dx; the kernel's (m, l))."""
    from .kernels import cross_entropy as kce
    loss, m, l = kce.fused_cross_entropy_fwd(logits, labels, ignore_index)
    dx = kce.fused_cross_entropy_bwd(logits, labels, m, l, g, ignore_index)
    x32 = logits.float()
    loss_p, m_p, l_p = kce._plain_fwd(x32, labels, ignore_index)
    dx_p = kce._plain_bwd(x32, labels, m_p, l_p, g, ignore_index)
    valid = (labels != ignore_index).float()
    dx_atol = CE_DX_FRAC * (g.abs() * valid).clamp_min(1e-30)[:, None]
    pairs = [(name, got, ref, *CE_LIMITS[name])
             for name, got, ref in (("loss", loss, loss_p), ("m", m, m_p),
                                    ("l", l, l_p))]
    pairs.append(("dx", dx, dx_p, dx_atol, CE_DX_RTOL[logits.dtype]))
    return pairs, (m, l)


# The fused cross-entropy cases the card checks: tag -> kwargs of
# `fused_ce_case`. "train" is the 7B training slice's shape; "v30522"
# has rows that do not start on a 16-byte boundary and end in a partial
# vector, so every row has a scalar head or tail.
FUSED_CE_CASES = {
    "train": {},
    "v30522": dict(N=1024, V=30522),
}


def fused_ce_readings(seed=0):
    """bf16 fused cross-entropy at `FUSED_CE_CASES` on the card: for each
    output (loss, m, l, dx), the worst err/limit over the cases (a
    reading above 1 is a miss)."""
    out = {}
    for kw in FUSED_CE_CASES.values():
        logits, labels, g = fused_ce_case(seed=seed, **kw)
        pairs, _ = fused_ce_pairs(logits, labels, g)
        for name, got, ref, atol, rtol in pairs:
            out[name] = max(out.get(name, 0.0), worst(got, ref, atol, rtol))
        del logits, labels, g, pairs
    return out


def train_launches(L, policy):
    """Kernel launches per training step of an L-layer LLaMA with the
    fused cross-entropy, by wrapper counter name; policy is "no remat"
    (use_recompute=False) or the remat policy its layers ran under
    (None counts as "nothing"). A rematerialised layer's recompute runs
    its forward up to its last saved tensor, the down projection's input;
    a site the policy keeps is not recomputed, and of the kernels only
    the SwiGLU output is a site (llama_swiglu, kept by
    save_matmul_outputs alone)."""
    recompute = 0 if policy == "no remat" else L
    swiglu_recompute = 0 if policy == "save_matmul_outputs" else recompute
    return {"rms_norm": L + 1 + recompute,
            "fused_add_rms_norm": L + recompute,
            "swiglu": L + swiglu_recompute,
            "swiglu_bwd_da": L, "swiglu_bwd_dw": L,
            "flash_attention_fwd": L + recompute,
            "flash_attention_bwd": L, "flash_attention_delta": L,
            "fused_cross_entropy": 1, "fused_cross_entropy_bwd": 1}


def train_counters():
    """The training kernels' wrappers by the counter names of
    `train_launches`; each wrapper's `launches` attribute counts its
    kernel launches."""
    from .kernels import cross_entropy as kce
    from .kernels import flash_attention as kfa
    from .kernels import fused_norm_residual as kfnr
    from .kernels import rms_norm as krn
    from .kernels import swiglu as ksw
    return {"rms_norm": krn.rms_norm,
            "fused_add_rms_norm": kfnr.fused_add_rms_norm,
            "swiglu": ksw.swiglu, "swiglu_bwd_da": ksw.swiglu_bwd_da,
            "swiglu_bwd_dw": ksw.swiglu_bwd_dw,
            "flash_attention_fwd": kfa.flash_attention_fwd,
            "flash_attention_bwd": kfa.flash_attention_bwd,
            "flash_attention_delta": kfa.flash_attention_delta,
            "fused_cross_entropy": kce.fused_cross_entropy_fwd,
            "fused_cross_entropy_bwd": kce.fused_cross_entropy_bwd}


# ------------------------------------------------ masked/packed attention


def seg_flash_terms(q, k, v, do, seg_q, seg_kv, causal, scale):
    """`flash_terms` for the segment-id kernels: f32 sums of |terms| of
    (o, dq, dk, dv) over the pairs the segment ids and the causal mask
    leave (P from the segment scores). seg_q [B, Sq], seg_kv [B, Sk]
    int32; q, k, v, do the plain side's f32 copies."""
    from .kernels import flash_attention as kfa
    group = q.shape[2] // k.shape[2]
    s = kfa._seg_scores(q, k, seg_q, seg_kv, causal, scale)
    p = torch.softmax(s, dim=-1)
    qh, kh, vh, doh = (t.transpose(1, 2).float() for t in (q, k, v, do))
    if group > 1:
        kh, vh = (t.repeat_interleave(group, dim=1) for t in (kh, vh))
    o = p @ vh
    o_t = p @ vh.abs()
    d_abs = (doh.abs() * o.abs()).sum(-1, keepdim=True)
    # the backward's P, exp(s - lse): P itself, but 1 (not 1 / Sk) on a
    # row with no key of its own segment, as the kernels recompute it
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    del s
    ds_t = p * ((doh @ vh.transpose(-1, -2)).abs() + d_abs)
    del o, d_abs
    dq_t = (ds_t @ kh.abs()) * abs(scale)
    dk_t = _group_sum(ds_t.transpose(-1, -2) @ qh.abs(), group) * abs(scale)
    dv_t = _group_sum(p.transpose(-1, -2) @ doh.abs(), group)
    return tuple(t.transpose(1, 2) for t in (o_t, dq_t, dk_t, dv_t))


def seg_flash_pairs(q, k, v, do, seg_q, seg_kv, causal, scale, heads=None):
    """The segment-id kernels (`flash_attention_seg_fwd`, the delta
    pre-pass `flash_attention_delta`, `_seg_dkv`, `_seg_dq`, as the
    route's autograd function launches them) and their plain version
    (`_SegPlain`) on f32 copies of the same inputs: q, k, v, do BSHD in one dtype (GQA callers pass q
    pre-scaled and scale 1). The plain side runs `heads` q heads at a
    time (a multiple of the GQA group; None: all), so a long packed
    batch's f32 [S, S] scores stay a few GB. Returns ([(label, kernel,
    plain, terms or None)] for o, lse, dq, dk, dv; the kernel's (o,
    lse))."""
    from .kernels import flash_attention as kfa
    o, lse = kfa.flash_attention_seg_fwd(q, k, v, seg_q, seg_kv, causal,
                                         scale)
    delta = kfa.flash_attention_delta(o, do)
    args = (q, k, v, do, lse, delta, seg_q, seg_kv, causal, scale)
    dk, dv = kfa.flash_attention_seg_dkv(*args)
    dq = kfa.flash_attention_seg_dq(*args)
    hq, group = q.shape[2], q.shape[2] // k.shape[2]
    heads = heads or hq
    parts = []
    for h0 in range(0, hq, heads):
        hs, ks = slice(h0, h0 + heads), slice(h0 // group,
                                              (h0 + heads) // group)
        ref = [q[:, :, hs].float().requires_grad_(),
               k[:, :, ks].float().requires_grad_(),
               v[:, :, ks].float().requires_grad_()]
        d = do[:, :, hs].float()
        with torch.enable_grad():
            o_p = kfa._SegPlain.apply(*ref, seg_q, seg_kv, causal, scale)
            o_p.backward(d)
        plain = [t.detach() for t in ref]
        lse_p = torch.logsumexp(kfa._seg_scores(plain[0], plain[1], seg_q,
                                                seg_kv, causal, scale),
                                dim=-1)
        parts.append((o_p.detach(), lse_p, ref[0].grad, ref[1].grad,
                      ref[2].grad)
                     + seg_flash_terms(*plain, d, seg_q, seg_kv, causal,
                                       scale))
        del ref, plain, o_p, lse_p, d
    (o_p, lse_p, dq_p, dk_p, dv_p, o_t, dq_t, dk_t, dv_t) = (
        torch.cat(ts, dim=1 if i == 1 else 2)
        for i, ts in enumerate(zip(*parts)))
    return ([("o", o, o_p, o_t), ("lse", lse, lse_p, None),
             ("dq", dq, dq_p, dq_t), ("dk", dk, dk_p, dk_t),
             ("dv", dv, dv_p, dv_t)], (o, lse))


def bert_lengths(B=16, S=512, seed=0):
    """Per-row valid lengths of the BERT phases' padded batch:
    default_rng(seed) draws B in [64, S], and row 0 is S long."""
    import numpy as np
    lengths = np.random.default_rng(seed).integers(64, S + 1, B)
    lengths[0] = S
    return [int(n) for n in lengths]


# The segment-id cases the card checks, in chip_smoke.py's kernel phase
# and the card tests: tag -> kwargs of `attn_seg_case`. "bert" is the
# BERT phase's padded batch at bert_base attention width; "packed_7b"
# the attention-surface phase's 8192 packed tokens in documents of
# default_rng(1) lengths in [128, 2048], causal, at llama_7b width;
# then small MHA/GQA/cross-length/packed cases; "qpad_causal" has query
# rows of a padding segment no key holds (rows with no key of their own
# segment, which average every visible key), causal, GQA.
ATTN_SEG_CASES = {
    "bert": dict(B=16, S=512, hq=12, hk=12, d=64, causal=False,
                 kind="bert"),
    "packed_7b": dict(B=1, S=8192, hq=32, hk=32, d=128, causal=True,
                      kind="packed"),
    "gqa_causal_pad": dict(B=2, S=256, hq=8, hk=2, d=128, causal=True,
                           kind="pad"),
    "cross_len": dict(B=3, S=200, Sk=328, hq=4, hk=4, d=64, causal=False,
                      kind="pad"),
    "mqa_packed": dict(B=1, S=700, hq=4, hk=1, d=64, causal=False,
                       kind="packed"),
    "qpad_causal": dict(B=2, S=300, hq=4, hk=2, d=64, causal=True,
                        kind="qpad"),
}


def packed_lengths(total=8192, lo=128, hi=2048, seed=1):
    """Document lengths of a packed batch: default_rng(seed) draws in
    [lo, hi] until they cover `total`; the last is cut to fit."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    while sum(out) < total:
        out.append(int(rng.integers(lo, hi + 1)))
    out[-1] -= sum(out) - total
    return out


def attn_seg_case(B, S, hq, hk, d, causal, kind, Sk=None,
                  dtype=torch.bfloat16, seed=0):
    """Inputs of a segment-id case on the card: q, do [B, S, hq, d], k, v
    [B, Sk, hk, d] N(0, 1) in dtype, and int32 segment ids: "bert" the
    padding segments of `bert_lengths` (q_seg = kv_seg); "pad" a padding
    mask with a short row (and, when Sk != S, a row with no valid key);
    "packed" 1-based ids of `packed_lengths` documents (for S = 8192) or
    of default_rng(seed) cuts; "qpad" the packed ids with each batch
    row's last 37 query ids set to 0, a segment no key holds. Returns (q,
    k, v, do, seg_q, seg_kv)."""
    import numpy as np
    from .kernels import flash_attention as kfa
    Sk = S if Sk is None else Sk
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = rand(B, S, hq, d), rand(B, S, hq, d)
    k, v = rand(B, Sk, hk, d), rand(B, Sk, hk, d)
    if kind in ("bert", "pad"):
        lengths = (bert_lengths(B, Sk) if kind == "bert"
                   else [Sk - 37 * (b + 1) for b in range(B)])
        pm = (torch.arange(Sk, device="cuda")[None, :]
              < torch.tensor(lengths, device="cuda")[:, None])
        if kind == "pad" and Sk != S:
            pm[-1] = False
        seg_q, seg_kv = kfa.padding_segments(pm, S, Sk)
    else:
        lengths = (packed_lengths(S) if S == 8192 else
                   [int(x) for x in np.diff(np.r_[0, np.sort(
                       np.random.default_rng(seed).choice(
                           np.arange(1, S), 5, replace=False)), S])])
        seg = torch.repeat_interleave(
            torch.arange(1, len(lengths) + 1, dtype=torch.int32,
                         device="cuda"),
            torch.tensor(lengths, device="cuda"))[None].expand(B, S)
        seg_q = seg_kv = seg
        if kind == "qpad":
            seg_q = seg.clone()
            seg_q[:, -37:] = 0
    return q, k, v, do, seg_q.contiguous(), seg_kv.contiguous()


def seg_flash_readings(seed=0):
    """Segment-id flash on the card at the "bert", "cross_len",
    "gqa_causal_pad" and "qpad_causal" cases (csrc/flash_wgmma.cu's
    forward, dkv and dq: the wgmma core in bf16, its 3xTF32 form in
    f32), bf16 and f32: for each output the worst
    err/limit over the cases under the element limit (terms; lse 1e-4 +
    1e-5 |plain|), f32's outputs as "<label>_f32". Above 1 is a miss."""
    out = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        frac = TERM_FRAC[dtype]
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
        for tag in ("bert", "cross_len", "gqa_causal_pad", "qpad_causal"):
            kw = ATTN_SEG_CASES[tag]
            q, k, v, do, sq, skv = attn_seg_case(**kw, dtype=dtype,
                                                 seed=seed)
            scale = q.shape[-1] ** -0.5
            # GQA: q pre-scaled in its dtype, the kernels at scale 1
            if q.shape[2] != k.shape[2]:
                q, scale = (q * scale).to(dtype), 1.0
            pairs, _ = seg_flash_pairs(q, k, v, do, sq, skv, kw["causal"],
                                       scale)
            for label, got, ref, terms in pairs:
                r = (worst(got, ref, 1e-4, 1e-5) if terms is None
                     else worst(got, ref, frac * terms, rtol))
                key = label + suffix
                out[key] = max(out.get(key, 0.0), r)
            del q, k, v, do, pairs
    return out


# The segment forwards' tiles in csrc/flash_wgmma.cu, (q rows a block,
# keys a kv tile) by (dtype, head dim): bf16 128 x 128; f32 (3xTF32)
# 128 x 64 at D = 64 and 128 x 32 at D = 128. VISIT_TILES: the kv tiles
# whose visit the kernels decide (kVisitTiles); later ones are visited.
SEG_FWD_TILES = {(torch.bfloat16, 64): (128, 128),
                 (torch.bfloat16, 128): (128, 128),
                 (torch.float32, 64): (128, 64),
                 (torch.float32, 128): (128, 32)}
# The segment backward's tiles there by (dtype, head dim): dq (q rows a
# block, keys a kv tile), walking `seg_visit_plan`'s tiles; dkv (kv rows
# a block, q rows a q tile), walking `seg_dkv_visit_plan`'s. bf16: 128 x
# 64 both; f32 (3xTF32, `Tf32BwdGeo`): 128 x 32 both at D = 64, dq 64 x
# 32 and dkv 64 x 16 at D = 128.
SEG_BWD_TILES = {(torch.bfloat16, 64): {"dq": (128, 64), "dkv": (128, 64)},
                 (torch.bfloat16, 128): {"dq": (128, 64), "dkv": (128, 64)},
                 (torch.float32, 64): {"dq": (128, 32), "dkv": (128, 32)},
                 (torch.float32, 128): {"dq": (64, 32), "dkv": (64, 16)}}
VISIT_TILES = 2048


def seg_visit_plan(seg_q, seg_kv, causal, BM, BN):
    """The segment forwards' visit plan (csrc/flash_wgmma.cu, `seg_plan`)
    in plain PyTorch: bool [B, ceil(Sq / BM), ceil(Sk / BN)], True where
    the block of q rows [i BM, (i + 1) BM) visits kv tile j. A block walks
    the tiles up to its causal limit; it skips a tile whose keys' [min,
    max] segment range misses its rows' range, and only when each of its
    rows i holds its own segment at key i (i < Sk and seg_kv[i] ==
    seg_q[i]), so that no row of it lacks a key of its own segment;
    otherwise it visits every tile. Tiles past VISIT_TILES are always
    visited."""
    B, Sq = seg_q.shape
    Sk = seg_kv.shape[1]
    n_qt, n_kt = -(-Sq // BM), -(-Sk // BN)
    big = torch.iinfo(torch.int32).max
    pad = n_kt * BN - Sk
    kv = torch.nn.functional.pad(seg_kv.long(), (0, pad), value=big)
    kmin = kv.view(B, n_kt, BN).amin(-1)
    kmax = torch.nn.functional.pad(seg_kv.long(), (0, pad),
                                   value=-big).view(B, n_kt, BN).amax(-1)
    plan = torch.zeros((B, n_qt, n_kt), dtype=torch.bool,
                       device=seg_q.device)
    tiles = torch.arange(n_kt, device=seg_q.device)
    for i in range(n_qt):
        q0, q1 = i * BM, min((i + 1) * BM, Sq)
        ids = seg_q[:, q0:q1].long()
        own = torch.zeros_like(ids, dtype=torch.bool)
        n_own = min(q1, Sk) - q0
        if n_own > 0:
            own[:, :n_own] = seg_kv[:, q0:q0 + n_own].long() == ids[:, :n_own]
        skip_ok = own.all(-1)                                   # [B]
        kv_end = min(Sk, q1) if causal else Sk
        n_kv = -(-kv_end // BN)
        qmin, qmax = ids.amin(-1), ids.amax(-1)
        meets = ~((kmax < qmin[:, None]) | (kmin > qmax[:, None]))
        visit = meets | ~skip_ok[:, None] | (tiles >= VISIT_TILES)[None]
        plan[:, i] = visit & (tiles < n_kv)[None]
    return plan


def seg_dkv_visit_plan(seg_q, seg_kv, causal, BM, BN):
    """The dkv kernel's visit plan (csrc/flash_wgmma.cu, `seg_dkv_plan`)
    in plain PyTorch, `seg_visit_plan`'s rule transposed: bool [B,
    ceil(Sk / BM), ceil(Sq / BN)], True where the block of kv rows [i BM,
    (i + 1) BM) visits q tile j (rows [j BN, (j + 1) BN)). A block walks
    the q tiles from its causal start (the tile of its first key; 0 when
    not causal). It skips a tile whose rows' [min, max] segment range
    misses its keys' range, and only when each row r of the tile holds
    its own segment at its own position (r < Sk and seg_kv[r] ==
    seg_q[r]): such a row's P on the block's keys is exactly 0, while a
    row with no key of its own segment has P = 1 on every key it sees.
    Tiles VISIT_TILES or more past the block's start are always
    visited."""
    B, Sq = seg_q.shape
    Sk = seg_kv.shape[1]
    n_kb, n_qt = -(-Sk // BM), -(-Sq // BN)
    big = torch.iinfo(torch.int32).max
    pad = torch.nn.functional.pad

    def ranges(ids, n, size):
        extra = n * size - ids.shape[1]
        return (pad(ids.long(), (0, extra), value=big).view(B, n, size)
                .amin(-1),
                pad(ids.long(), (0, extra), value=-big).view(B, n, size)
                .amax(-1))

    qmin, qmax = ranges(seg_q, n_qt, BN)                      # [B, n_qt]
    kmin, kmax = ranges(seg_kv, n_kb, BM)                     # [B, n_kb]
    own = torch.zeros((B, Sq), dtype=torch.bool, device=seg_q.device)
    n = min(Sq, Sk)
    own[:, :n] = seg_kv[:, :n].long() == seg_q[:, :n].long()
    good = pad(own, (0, n_qt * BN - Sq), value=True).view(
        B, n_qt, BN).all(-1)                                  # [B, n_qt]
    meets = ~((qmax[:, None, :] < kmin[:, :, None])
              | (qmin[:, None, :] > kmax[:, :, None]))        # [B, kb, qt]
    tiles = torch.arange(n_qt, device=seg_q.device)
    start = (torch.arange(n_kb, device=seg_q.device) * BM // BN if causal
             else torch.zeros(n_kb, dtype=torch.long, device=seg_q.device))
    rel = tiles[None, :] - start[:, None]                     # [kb, qt]
    visit = meets | ~good[:, None, :] | (rel >= VISIT_TILES)[None]
    return visit & (rel >= 0)[None]


def seg_plan_keep(plan, BM, BN, rows, cols):
    """A [B, blocks, tiles] visit plan as a bool [B, rows, cols] mask of
    the pairs (block row, tile column) its visited tiles hold."""
    return plan.repeat_interleave(BM, 1)[:, :rows].repeat_interleave(
        BN, 2)[:, :, :cols]


def seg_plan_attention(q, k, v, seg_q, seg_kv, causal, scale, BM, BN):
    """The segment forward over the pairs of `seg_visit_plan`'s tiles
    alone, f32 inside: `_seg_scores`, every score outside a visited tile
    -inf, softmax. Equal to the full segment forward when the plan is
    exact. Returns (o [B, Sq, Hq, D] f32, lse [B, Hq, Sq])."""
    from .kernels import flash_attention as kfa
    s = kfa._seg_scores(q, k, seg_q, seg_kv, causal, scale)
    Sq, Sk = s.shape[-2], s.shape[-1]
    keep = seg_plan_keep(seg_visit_plan(seg_q, seg_kv, causal, BM, BN), BM,
                         BN, Sq, Sk)
    s = s.masked_fill(~keep[:, None], float("-inf"))
    group = q.shape[2] // v.shape[2]
    vh = v.transpose(1, 2).float()
    if group > 1:
        vh = vh.repeat_interleave(group, dim=1)
    o = torch.softmax(s, dim=-1) @ vh
    return o.transpose(1, 2), torch.logsumexp(s, dim=-1)


def seg_plan_grads(q, k, v, do, seg_q, seg_kv, causal, scale,
                   tiles=None):
    """The segment backward over each plan's visited tiles alone, f32
    inside, as the kernels form it: P = exp(s - lse) from the whole
    forward's lse (1 on the masked keys of a row with no key of its own
    segment), D = rowsum(dO * O) over the whole forward's O; dq sums over
    the pairs of the tiles `seg_visit_plan` visits at tiles["dq"] (q rows
    a block, keys a tile), dk and dv over those `seg_dkv_visit_plan`
    visits at tiles["dkv"] (kv rows a block, q rows a tile); tiles: the
    kernels' for q's dtype and head dim (`SEG_BWD_TILES`) by default.
    Equal to the whole segment backward
    (`_SegPlain`'s) when both plans are exact. q, k, v, do BSHD; returns
    (dq, dk, dv) BSHD f32."""
    from .kernels import flash_attention as kfa
    tiles = tiles or SEG_BWD_TILES[(q.dtype, q.shape[-1])]
    s = kfa._seg_scores(q, k, seg_q, seg_kv, causal, scale)
    Sq, Sk = s.shape[-2], s.shape[-1]
    group = q.shape[2] // k.shape[2]
    qh, kh, vh, doh = (t.transpose(1, 2).float() for t in (q, k, v, do))
    if group > 1:
        kh, vh = (t.repeat_interleave(group, dim=1) for t in (kh, vh))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    o = torch.softmax(s, dim=-1) @ vh
    del s
    ds = p * (doh @ vh.transpose(-1, -2)
              - (doh * o).sum(-1, keepdim=True))
    BM, BN = tiles["dq"]
    keep = seg_plan_keep(seg_visit_plan(seg_q, seg_kv, causal, BM, BN), BM,
                         BN, Sq, Sk)[:, None]
    dq = (ds * keep) @ kh * scale
    BM, BN = tiles["dkv"]
    keep = seg_plan_keep(seg_dkv_visit_plan(seg_q, seg_kv, causal, BM, BN),
                         BM, BN, Sk, Sq).transpose(1, 2)[:, None]
    dk = _group_sum((ds * keep).transpose(-1, -2) @ qh, group) * scale
    dv = _group_sum((p * keep).transpose(-1, -2) @ doh, group)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


# The f32 segment forward's 3xTF32 split (csrc/hopper.cuh tf32_round,
# flash_wgmma.cu split_tf32), mirrored for the CPU: round to 10 mantissa
# bits, to nearest with ties away from zero, as the bit operation the
# kernel runs.
def tf32_round(x):
    """x (f32) rounded to tf32, as f32 with the low 13 bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """x = hi + lo, both tf32 (lo the rounded remainder):
    |x - hi - lo| <= 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


# The f32 forward's V^T key order within each group of 8: position k of
# a k8 slice holds key VT_KEY_ORDER[k], so that P's tf32 A fragment
# (columns c and c + 4 of each quad) is the score accumulators' pair (2c,
# 2c + 1) as it stands.
VT_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def vt_positions(n):
    """The position of each of n keys (n a multiple of 8) in V^T's k
    order (flash_wgmma.cu, vt_pos)."""
    r = torch.arange(n)
    w = r % 8
    return (r - w) + torch.where(w % 2 == 1, 4 + w // 2, w // 2)


# block-stats (m, l): (atol, rtol) in f32 from either input dtype; l and
# o also take STATS_M_FRAC (1 + |m|) of their own value (2^-20: the
# 2^-22 |m| a score's rounding gives, with a margin of four)
STATS_LIMITS = {"m": (1e-5, 1e-5), "l": (1e-5, 1e-5)}
STATS_M_FRAC = 2.0 ** -20
STATS_O_RTOL = {torch.bfloat16: BF16_RTOL, torch.float32: 0.0}

# The block-stats cases the card checks: tag -> kwargs of `stats_case`.
# "sdpa_bias" is sdpa's bias route at bert width, the float [16, 1, 1,
# 512] padding mask (0 / -1e4) as one 512-key chunk; "alibi_7b" the
# first 512-key chunk of the causal alibi case at llama_7b width (of 4),
# "alibi_7b_4096" that of its 2 x 4096 memory case (of 8); "masked" a
# small case with a boolean mask, a full bias holding -1e30
# and -inf rows and keys, and a ragged edge; "ring_7b" the diagonal round
# of ring attention at llama_7b width (16,384 tokens over four ranks: a
# rank's 4096 queries against its own 4096 keys, no bias, the causal
# [4096, 4096] boolean mask), the kernel's next caller. "row_500" and
# "mask_328" hold the narrow-bias geometry (four ring stages) to ragged
# key counts over more tiles than it has stages: sdpa's [B, 1, 1, Sk]
# padding bias at Sk = 500, and a boolean mask with no bias (a fully
# masked row 11) at Sk = 328.
STATS_CASES = {
    "sdpa_bias": dict(B=16, Sq=512, Sk=512, H=12, d=64, kind="sdpa_bias"),
    "alibi_7b": dict(B=4, Sq=2048, Sk=512, H=32, d=128, kind="alibi"),
    "alibi_7b_4096": dict(B=2, Sq=4096, Sk=512, H=32, d=128, kind="alibi"),
    "masked": dict(B=2, Sq=200, Sk=328, H=3, d=128, kind="masked"),
    "ring_7b": dict(B=1, Sq=4096, Sk=4096, H=32, d=128, kind="ring"),
    "row_500": dict(B=3, Sq=300, Sk=500, H=3, d=64, kind="sdpa_bias"),
    "mask_328": dict(B=2, Sq=200, Sk=328, H=3, d=128, kind="mask"),
}


def stats_case(B, Sq, Sk, H, d, kind, dtype=torch.bfloat16, seed=0):
    """Inputs of a block-stats case on the card: q [B, Sq, H, d], k, v
    [B, Sk, H, d] N(0, 1) in dtype, a mask or None, the scale, and the
    f32 bias as the route passes it (compact, broadcastable) or None.
    Returns (q, k, v, mask, scale, bias)."""
    from .kernels import flash_attention as kfa
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rand(B, Sq, H, d), rand(B, Sk, H, d), rand(B, Sk, H, d)
    mask = None
    if kind == "sdpa_bias":
        lengths = torch.tensor(bert_lengths(B, Sk), device="cuda")
        valid = torch.arange(Sk, device="cuda")[None, :] < lengths[:, None]
        bias = torch.where(valid, 0.0, -1e4).float()[:, None, None, :]
    elif kind == "alibi":
        bias = kfa._bias_chunk("alibi", alibi_slopes(H), Sq, 0, Sk, True,
                               None)
    elif kind == "ring":
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda").tril()
        bias = None
    elif kind == "mask":
        mask = torch.rand((Sq, Sk), generator=gen, device="cuda") > 0.3
        mask[11] = False
        bias = None
    else:
        mask = torch.rand((Sq, Sk), generator=gen, device="cuda") > 0.3
        bias = 0.5 * torch.randn((B, H, Sq, Sk), generator=gen,
                                 device="cuda")
        bias[0, 0, 3] = -1e30
        bias[1, 2, 7] = -float("inf")
        bias[:, 1, :, 5] = -float("inf")
        mask[11] = False
    return q, k, v, mask, d ** -0.5, bias


def block_stats_pairs(q, k, v, mask, scale, bias):
    """The block-stats kernel and its plain version (`_dense_stats`) on f32
    copies of the same inputs. Returns [(label, kernel, plain, atol,
    rtol)] for m, l and o (o's atol TERM_FRAC of its element's sum of
    |terms|, P |V|)."""
    from .kernels import block_attention as kba
    m, l, o = kba.block_attention_fwd(q, k, v, mask, scale, bias)
    qf, kf, vf = q.float(), k.float(), v.float()
    m_p, l_p, o_p = kba._dense_stats(qf, kf, vf, mask, scale, bias)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s, valid = kba._apply_bias_mask(s, mask, bias)
    p = torch.where(valid, torch.exp(s - m_p[..., None]), 0.0)
    o_t = torch.einsum("bhqk,bkhd->bqhd", p, vf.abs())
    del s, valid, p
    # a fully masked row has m = -1e30 and l = o = 0: its share is 0
    m_share = STATS_M_FRAC * (1.0 + m_p.abs())
    l_atol, l_rtol = STATS_LIMITS["l"]
    o_frac = (TERM_FRAC[q.dtype]
              + m_share.transpose(1, 2)[..., None])
    return [("m", m, m_p, *STATS_LIMITS["m"]),
            ("l", l, l_p, l_atol + m_share * l_p, l_rtol),
            ("o", o, o_p, o_frac * o_t, STATS_O_RTOL[q.dtype])]


def block_stats_readings(seed=0):
    """bf16 block stats at `STATS_CASES` on the card: for each output the
    worst err/limit over the cases (above 1 is a miss)."""
    out = {}
    for kw in STATS_CASES.values():
        for label, got, ref, atol, rtol in block_stats_pairs(
                *stats_case(**kw, seed=seed)):
            out[label] = max(out.get(label, 0.0),
                             worst(got, ref, atol, rtol))
    return out


# ------------------------------------------------------- biased route

# The bias-kernel cases the card checks, in chip_smoke.py's kernel phase
# and the card tests: tag -> kwargs of `bias_case`. "alibi_7b" is the
# surface phase's causal alibi at llama_7b width, "alibi_7b_4096" its
# memory case; "sdpa_float" the surface phase's sdpa float mask (0
# valid, -1e4 padding, [16, 1, 1, 512] on `bert_lengths`) at bert width;
# "rel_table_bert" a T5-style table (R = 128) at bert width, full;
# "masked" a small dense-bias case with a ragged edge, Sq != Sk causal
# (top-left), GQA, -inf and -1e30 rows, a -inf key and a batch row with
# no valid key; "alibi_gqa" a small causal GQA alibi case.
BIAS_CASES = {
    "alibi_7b": dict(B=4, Sq=2048, Sk=2048, hq=32, hk=32, d=128,
                     kind="alibi", causal=True),
    "alibi_7b_4096": dict(B=2, Sq=4096, Sk=4096, hq=32, hk=32, d=128,
                          kind="alibi", causal=True),
    "sdpa_float": dict(B=16, Sq=512, Sk=512, hq=12, hk=12, d=64,
                       kind="sdpa_float", causal=False),
    "rel_table_bert": dict(B=16, Sq=512, Sk=512, hq=12, hk=12, d=64,
                           kind="rel_table", causal=False),
    "masked": dict(B=3, Sq=200, Sk=328, hq=8, hk=2, d=64, kind="masked",
                   causal=True),
    "alibi_gqa": dict(B=2, Sq=512, Sk=512, hq=8, hk=2, d=128, kind="alibi",
                      causal=True),
}


def alibi_slopes(H, device="cuda"):
    """The surface phase's alibi slopes, 2^(-8 h / H) for h = 1..H."""
    return 2.0 ** (-8.0 * torch.arange(1, H + 1, device=device) / H)


def bias_case(B, Sq, Sk, hq, hk, d, kind, causal, dtype=torch.bfloat16,
              seed=0):
    """Inputs of a bias case on the card: q, do [B, Sq, hq, d], k, v
    [B, Sk, hk, d] N(0, 1) in dtype, and the bias as
    `flash_attention_biased` takes it. Returns a dict: q, k, v, do, kind
    ("alibi", "rel_table" or "dense"), param, R (rel_table) or None,
    padding_mask [B, Sk] bool or None, causal, scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = rand(B, Sq, hq, d), rand(B, Sq, hq, d)
    k, v = rand(B, Sk, hk, d), rand(B, Sk, hk, d)
    R, pm = None, None
    if kind in ("src_mask", "beam_mask"):
        # the Transformer phase's source masks: 0 / -1e9 over the
        # training batch's lengths, or the beam search's 16 sources, each
        # folded into its beam of consecutive rows
        lengths = (transformer_lengths(B, 0) if kind == "src_mask" else
                   [n for n in transformer_lengths(B // TRANSFORMER_BEAM, 1)
                    for _ in range(TRANSFORMER_BEAM)])
        kind, param = "dense", transformer_src_mask(lengths, Sk, "cuda")
    elif kind == "sdpa_float":
        lengths = torch.tensor(bert_lengths(B, Sk), device="cuda")
        valid = torch.arange(Sk, device="cuda")[None, :] < lengths[:, None]
        kind, param = "dense", torch.where(valid, 0.0, -1e4).float()[
            :, None, None, :]
    elif kind == "alibi":
        param = alibi_slopes(hq)
    elif kind == "rel_table":
        R = 128
        param = 0.5 * torch.randn((hq, 2 * R + 1), generator=gen,
                                  device="cuda")
    else:
        kind = "dense"
        param = 0.5 * torch.randn((B, 1, Sq, Sk), generator=gen,
                                  device="cuda")
        param[0, 0, 7] = -float("inf")
        param[1, 0, 3] = -1e30
        param[:, 0, :, 5] = -float("inf")
        param[0, 0, 11, ::2] = -1e4
        pm = torch.arange(Sk, device="cuda")[None, :] < torch.tensor(
            [[Sk - 37], [Sk], [0]], device="cuda")
    return dict(q=q, k=k, v=v, do=do, kind=kind, param=param, R=R,
                padding_mask=pm, causal=causal, scale=d ** -0.5)


def bias_flash_terms(q, k, v, do, o, lse, kind, param, R, causal, scale,
                     padding_mask):
    """`flash_terms` for the bias kernels, over KV chunks: f32 sums of
    |terms| of (o, dq, dk, dv), P = exp(s * scale + bias - lse) over the
    entries the bias and the masks leave. q, k, v, do, o are the plain
    side's f32 tensors, lse its [B, Hq, Sq] log-sum-exp."""
    from .kernels import flash_attention as kfa
    group = q.shape[2] // k.shape[2]
    qh, doh = q.transpose(1, 2).float(), do.transpose(1, 2).float()
    d_abs = (doh.abs() * o.transpose(1, 2).abs()).sum(-1, keepdim=True)
    o_t, dq_t = torch.zeros_like(qh), torch.zeros_like(qh)
    dk_t, dv_t = torch.empty_like(k), torch.empty_like(v)
    for s0, s1, kc, p, dp, _, _ in kfa._bwd_chunks(
            qh, k, v, doh, lse, kind, param, R, causal, scale, padding_mask,
            None):
        o_t += p @ kfa._kv_chunk(v, s0, s1, group).abs()
        ds_t = dp.abs_().add_(d_abs).mul_(p)
        dq_t += (ds_t @ kc.abs()) * abs(scale)
        dk_t[:, s0:s1] = (_group_sum(ds_t.transpose(-1, -2) @ qh.abs(), group)
                          * abs(scale)).transpose(1, 2)
        dv_t[:, s0:s1] = _group_sum(p.transpose(-1, -2) @ doh.abs(),
                                    group).transpose(1, 2)
        del p, dp, ds_t, kc
    return o_t.transpose(1, 2), dq_t.transpose(1, 2), dk_t, dv_t


def bias_flash_pairs(q, k, v, do, kind, param, R, padding_mask, causal,
                     scale):
    """The bias kernels (`flash_attention_bias_fwd`, `_dkv`, `_dq`) and
    their plain versions (`_biased_plain_fwd`, `_biased_plain_bwd`) on
    f32 copies of the same inputs. A row with no valid key has lse +inf
    on both sides: there the lse pair compares 0 with 0 when the kernel
    also wrote +inf, and NaN (a miss) when it did not. Returns ([(label,
    kernel, plain, terms or None)] for o, lse, dq, dk, dv; the kernel's
    (o, lse))."""
    from .kernels import flash_attention as kfa
    a = kfa._bias_args(kind, param, R, padding_mask, q.shape, k.shape)
    o, lse = kfa.flash_attention_bias_fwd(q, k, v, a, causal, scale)
    delta = kfa._delta(o, do)
    args = (q, k, v, do, lse, delta, a, causal, scale)
    dk, dv = kfa.flash_attention_bias_dkv(*args)
    dq = kfa.flash_attention_bias_dq(*args)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    plain = (kind, param, R, causal, scale, padding_mask, None)
    o_p, lse_p = kfa._biased_plain_fwd(qf, kf, vf, *plain)
    dq_p, dk_p, dv_p = kfa._biased_plain_bwd(qf, kf, vf, o_p, lse_p, dof,
                                             *plain)
    terms = bias_flash_terms(qf, kf, vf, dof, o_p, lse_p, kind, param, R,
                             causal, scale, padding_mask)
    empty = torch.isinf(lse_p)
    lse_k = torch.where(empty, torch.where(torch.isinf(lse), 0.0,
                                           float("nan")), lse)
    lse_pp = torch.where(empty, 0.0, lse_p)
    return ([("o", o, o_p, terms[0]), ("lse", lse_k, lse_pp, None),
             ("dq", dq, dq_p, terms[1]), ("dk", dk, dk_p, terms[2]),
             ("dv", dv, dv_p, terms[3])], (o, lse))


def bias_flash_readings(seed=0):
    """bf16 bias kernels at the "masked" and "alibi_gqa" cases on the
    card: for each output the worst err/limit over the cases under the
    flash rule (terms; lse 1e-4 + 1e-5 |plain|). Above 1 is a miss."""
    frac = TERM_FRAC[torch.bfloat16]
    out = {}
    for tag in ("masked", "alibi_gqa"):
        c = bias_case(**BIAS_CASES[tag], seed=seed)
        pairs, _ = bias_flash_pairs(c["q"], c["k"], c["v"], c["do"],
                                    c["kind"], c["param"], c["R"],
                                    c["padding_mask"], c["causal"],
                                    c["scale"])
        for label, got, ref, terms in pairs:
            r = (worst(got, ref, 1e-4, 1e-5) if terms is None
                 else worst(got, ref, frac * terms, BF16_RTOL))
            out[label] = max(out.get(label, 0.0), r)
    return out


def attention_counters():
    """Every attention kernel's wrapper by counter name (the segment
    kernels, the bias kernels, the block-stats kernel, and the one-length
    flash, paged and ragged kernels), for the phases that must show which
    ran."""
    from .kernels import block_attention as kba
    from .kernels import flash_attention as kfa
    from .kernels import paged_attention as kpa
    from .kernels import ragged_paged_attention as krpa
    return {"flash_attention_seg_fwd": kfa.flash_attention_seg_fwd,
            "flash_attention_seg_dkv": kfa.flash_attention_seg_dkv,
            "flash_attention_seg_dq": kfa.flash_attention_seg_dq,
            "flash_attention_bias_fwd": kfa.flash_attention_bias_fwd,
            "flash_attention_bias_dkv": kfa.flash_attention_bias_dkv,
            "flash_attention_bias_dq": kfa.flash_attention_bias_dq,
            "block_attention_stats": kba.block_attention_fwd,
            "flash_attention_fwd": kfa.flash_attention_fwd,
            "flash_attention_bwd": kfa.flash_attention_bwd,
            "flash_attention_delta": kfa.flash_attention_delta,
            "paged_decode_attention": kpa.paged_decode_attention,
            "ragged_paged_attention": krpa.ragged_paged_attention}


# Route agreement, kernel route against plain route. Attention surface
# (bf16 at bert width): max |a - b| / max |b| over the valid rows of the
# output and of dq, dk, dv, for each route against its plain route and
# the three routes against each other; the kernels round P and dS to
# bf16 (about 2^-8 each; up to 0.5% of max|b| on an H100 at small
# shapes), so the limit is about four times that.
SURFACE_RTOL = 0.02
# BERT (f32, bert_base, 12 layers, batch 16 x 512): |difference| of the
# sequence output and of the logits at valid rows, max and mean. Both
# routes are f32 and differ by summation order only (the SIMT kernel's
# against the plain version's batched products): a few f32 ulps per
# layer, compounded through 12 post-LN layers of random weights; the
# limits allow about 1e-3 of the values' scale (LayerNorm'd outputs of
# order 1, logits of order 0.5).
BERT_SEQ_ATOL = 2e-3
BERT_SEQ_MEAN_ATOL = 2e-4
BERT_LOGIT_ATOL = 2e-3
BERT_LOGIT_MEAN_ATOL = 2e-4


# ------------------------------------------------ encoder training

# Dropout masks (chip_smoke.py's encoder phase (e), tests/
# test_torch_dropout.py and test_torch_encoder_train.py): a keep mask of
# n elements at drop probability p keeps a binomial count; its share
# must lie within DROPOUT_SIGMAS standard deviations, sqrt(n p (1 - p)),
# of n (1 - p). Five give a false alarm about once in 1.7 million draws.
DROPOUT_SIGMAS = 5.0


def keep_share_sigmas(keep, p) -> float:
    """How many binomial standard deviations a bool keep mask's count
    lies from n (1 - p)."""
    n = keep.numel()
    return (int(keep.sum()) - n * (1.0 - p)) / math.sqrt(n * p * (1.0 - p))


# Encoder training, kernel route against plain route (chip_smoke.py's
# encoder phase): a 2-layer full-width model at 16 x 512 in f32, dropout
# 0, one train-mode forward and backward on each route from the same
# weights: |loss difference| / |loss| and the largest per-parameter
# relative L2 error of the grads. ERNIE (b) runs row 10's one-length
# f32 kernels (3xTF32), BERT (d) its f32 segment kernels under a
# padding mask; the plain route keeps f32 products. The kernels and
# cuBLAS are deterministic at a shape, so a reading repeats. The first
# readings on an H100 (NVIDIA H100 80GB HBM3, 700 W) are beside each;
# the grad limits give about ten times that, the loss limits (read 0:
# the two f32 losses were equal) about eight f32 roundoffs.
ENCODER_LOSS_RTOL = 1e-6        # read 0
ENCODER_GRAD_RTOL = 5e-5        # read 4.90e-6 (blocks.1.fc1.weight)
BERT_TRAIN_LOSS_RTOL = 1e-6     # read 0
BERT_TRAIN_GRAD_RTOL = 5e-5     # read 4.00e-6 (layers.1.attention.out)


def encoder_counters():
    """The attention kernels' wrappers an encoder's training step can
    reach, by counter name: the one-length flash kernels (ERNIE, BERT
    without a mask), the segment kernels (BERT with a padding mask), the
    bias kernels and the block-stats kernel (on no encoder's route)."""
    from .kernels import block_attention as kba
    from .kernels import flash_attention as kfa
    return {"flash_attention_fwd": kfa.flash_attention_fwd,
            "flash_attention_delta": kfa.flash_attention_delta,
            "flash_attention_bwd": kfa.flash_attention_bwd,
            "flash_attention_seg_fwd": kfa.flash_attention_seg_fwd,
            "flash_attention_seg_dkv": kfa.flash_attention_seg_dkv,
            "flash_attention_seg_dq": kfa.flash_attention_seg_dq,
            "flash_attention_bias_fwd": kfa.flash_attention_bias_fwd,
            "flash_attention_bias_dkv": kfa.flash_attention_bias_dkv,
            "flash_attention_bias_dq": kfa.flash_attention_bias_dq,
            "block_attention_stats": kba.block_attention_fwd}


def encoder_launches(L, passes, route):
    """Launches by `encoder_counters` name of `passes` forward and
    backward passes through an L-layer encoder: route "flash" (the
    one-length kernels: a forward, the delta pre-pass and a backward a
    layer), "segment" (a padding mask: the segment forward, the delta
    pre-pass, dkv and dq a layer) or "dense" (BERT's probs-dropout
    route: none). Names left out launch 0 times."""
    n = L * passes
    if route == "flash":
        names = ("flash_attention_fwd", "flash_attention_delta",
                 "flash_attention_bwd")
    elif route == "segment":
        names = ("flash_attention_seg_fwd", "flash_attention_delta",
                 "flash_attention_seg_dkv", "flash_attention_seg_dq")
    elif route == "dense":
        names = ()
    else:
        raise ValueError(f"encoder_launches: unknown route {route!r}")
    return {name: n for name in names}


# ------------------------------------------------ the optimizer surface

# Each optimizer on the card against the same optimizer on the CPU
# (chip_smoke phase 9c (c)): both update the same f32 weights from the
# same grads (the card's, copied to the CPU), so an elementwise update is
# the same IEEE operations on both sides; a reduction's order (a clip's
# norm, Lamb's trust ratio) may differ by f32 roundoffs. Every parameter
# and every accumulator after each step: max|card - cpu| <= OPT_CARD_RTOL
# * max|cpu| (`max_rel`).
OPT_CARD_RTOL = 1e-6
# LBFGS runs its closure on each device: the card's grads come from the
# kernels (the f32 flash in 3xTF32), the CPU's from the plain routes,
# about 1e-5 apart relative (ENCODER_GRAD_RTOL), and the two-loop
# recursion carries that difference into each direction.
OPT_LBFGS_RTOL = 1e-3
# accumulate_steps=2 against one full-batch step of llama_1b bf16 at 4 x
# 2048 from the same weights (9c (c)): the micro-batches' grads are the
# full batch's up to bf16 roundings of the two partial sums, so the
# losses agree to f32 summation order and bf16 rows; AdamW's first step
# moves an element by +-lr whatever the size of its grad, so elements
# differ only where the two grads' signs differ (grads near 0): 2 lr on
# weights of std 0.02, 0.03 sqrt(share) relative L2 a tensor.
ACCUM_LOSS_RTOL = 1e-3
ACCUM_WEIGHT_RL2 = 5e-3


def max_rel(got, want) -> float:
    """max|got - want| / max|want| (0 when both are all zeros), in f32:
    the difference of two f32 values within a factor 2 of each other is
    exact."""
    den = want.float().abs().max().item()
    num = (got.float() - want.float()).abs().max().item()
    return num / den if den else num


def opt_card_cases(opt, nn):
    """name -> factory(parameters) of the optimizers 9c (c) holds on the
    card: each of the twelve but LBFGS (its closure runs apart), Adam
    with amsgrad, RMSProp centered with momentum, Momentum with
    Nesterov, and each gradient clip."""
    lr = opt.lr
    return {
        "sgd": lambda ps: opt.SGD(1e-3, parameters=ps, weight_decay=0.01),
        "momentum_nesterov": lambda ps: opt.Momentum(
            1e-3, momentum=0.9, parameters=ps, use_nesterov=True),
        "adam_amsgrad": lambda ps: opt.Adam(1e-4, parameters=ps,
                                            amsgrad=True),
        "adamw": lambda ps: opt.AdamW(
            lr.CosineAnnealingDecay(1e-4, T_max=10), parameters=ps,
            weight_decay=0.1),
        "adamax": lambda ps: opt.Adamax(1e-4, parameters=ps),
        "adagrad": lambda ps: opt.Adagrad(
            1e-3, parameters=ps, initial_accumulator_value=0.1),
        "adadelta": lambda ps: opt.Adadelta(1.0, parameters=ps),
        "rmsprop_centered": lambda ps: opt.RMSProp(
            1e-4, momentum=0.9, centered=True, parameters=ps),
        "lamb": lambda ps: opt.Lamb(1e-4, parameters=ps),
        "asgd": lambda ps: opt.ASGD(1e-3, batch_num=2, parameters=ps),
        "rprop": lambda ps: opt.Rprop(1e-4, parameters=ps),
        "adamw_clip_value": lambda ps: opt.AdamW(
            1e-4, parameters=ps, grad_clip=nn.ClipGradByValue(1e-3)),
        "adamw_clip_norm": lambda ps: opt.AdamW(
            1e-4, parameters=ps, grad_clip=nn.ClipGradByNorm(0.01)),
        "adamw_clip_global_norm": lambda ps: opt.AdamW(
            1e-4, parameters=ps, grad_clip=nn.ClipGradByGlobalNorm(0.1)),
    }


# CUDA runtime calls that hold the host until the card (a stream, an
# event, the whole device) has caught up, by the names torch.profiler
# reports them; a `.cpu()` read-back is a cudaMemcpyAsync then a
# cudaStreamSynchronize. The telemetry's event record and query
# (cudaEventRecord, cudaEventQuery) and its elapsed-time read
# (cudaEventElapsedTime) do not wait.
SYNC_CALLS = frozenset(("cudaDeviceSynchronize", "cudaStreamSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy",
                        "cudaMemcpy2D"))


def sync_calls(events) -> int:
    """How many of a torch.profiler run's events (`prof.events()`) are
    synchronizing CUDA runtime calls (`SYNC_CALLS`)."""
    return sum(1 for e in events if e.name in SYNC_CALLS)


class ObservationTap:
    """Stands in for a metrics histogram (`device_events._H_EXECUTE`):
    records each observation as (executable label, value) in `seen`
    and passes it on to the histogram it wraps."""

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def observe(self, v, exemplar=None, **labels):
        self.seen.append((labels.get("executable"), v))
        self.inner.observe(v, exemplar=exemplar, **labels)


# ---------------------------------------------------------------- row 14
# W8A16 against its plain version: (atol, rtol) of the rule; rtol two
# bf16 roundoffs, atol the f32 summation order near zero
W8A16_LIMIT = (1e-4, BF16_RTOL)
# llama_7b's quantized products in a serving step: name -> (K, N,
# SwiGLU epilogue); qkv, o, the [Wg | Wu] MLP, down, the lm head
W8A16_SHAPES = {"qkv": (4096, 12288, False), "o": (4096, 4096, False),
                "gate_up": (4096, 22016, True),
                "down": (11008, 4096, False),
                "lm_head": (4096, 32000, False)}
# row counts: decode and the lm head's 4, the ragged step's 128 packed
# rows, ragged edges around the kernel's 64-row tile
W8A16_ROWS = (1, 4, 5, 63, 64, 65, 127, 128, 130)
# scale layouts: per column (the serving rule), per tensor, per group
W8A16_LAYOUTS = ("column", "tensor", "group64", "group128")


def w8a16_case(M, K, N, layout="column", dtype=torch.bfloat16, seed=0,
               device="cuda"):
    """a [M, K] ~ N(0, 1) in `dtype` and an int8 weight [K, N] quantized
    from N(0, 0.02) by the layout's rule: "column" the serving rule
    (`quantization.comm.channelwise_absmax_int8`, scale [1, N]),
    "tensor" one absmax scale [1], "groupG" incubate's group rule
    (`weight_quantize(group_size=G)`, scale [K / G, N]). Returns (a, q,
    scale)."""
    from .incubate.nn import functional as IF
    from .quantization import comm
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((M, K), generator=g, device=device).to(dtype)
    w = 0.02 * torch.randn((K, N), generator=g, device=device)
    if layout == "column":
        q, s = comm.channelwise_absmax_int8(w, axis=0)
    elif layout == "tensor":
        s = torch.clamp_min(w.abs().max() / 127.0, 1e-8).reshape(1)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    else:
        q, s = IF.weight_quantize(w, group_size=int(layout[5:]))
    return a, q, s


def w8a16_pair(a, q, s, swiglu=False, bias=None):
    """(kernel output, plain f32 output, atol): the kernel on the card
    against the plain version's dequantized weight (the same bf16
    values) in an f32 product; with a bias the plain product is rounded
    to a's dtype before the add, as the kernel does, and the atol takes
    one roundoff of that product on top of `W8A16_LIMIT`'s."""
    from .kernels import swiglu as ksw
    from .kernels import weight_only_linear as kwol
    out = kwol.weight_only_linear(a, q, s, bias=bias, swiglu=swiglu,
                                  use_kernel=True)
    w = kwol.dequantize(q, s, a.dtype).float()
    atol = W8A16_LIMIT[0]
    if swiglu:
        return out, ksw._ref(a.float(), w), atol
    ref = a.float() @ w
    if bias is not None:
        atol = atol + BF16_RTOL * ref.abs()
        ref = ref.to(a.dtype).float() + bias.float()
    return out, ref, atol


def w8a16_switch_rows(K, N, swiglu=False):
    """The row counts at both sides of every switch of the W8A16 kernel's
    `plan` for a [K, N] weight (the products' N, scratch against the
    in-register merge, one row group against several), and 512 (the
    bucketed prefill): where the card holds each row of an M-row
    product bitwise to its 1-row product."""
    from .kernels import weight_only_linear as kwol
    rows = {512}
    for m in kwol.route_switches(K, N, swiglu):
        rows |= {m, m + 1}
    return sorted(rows)


# the same rows for every shape the card checks: kwol.route_switches
# gives 8, 32, 64 and 128 wherever S > 1 (test_torch_w8a16_plan.py)
W8A16_SWITCH_ROWS = (8, 9, 32, 33, 64, 65, 128, 129, 512)


def w8a16_rows_independent(a, q, s, swiglu=False):
    """How many rows of an M-row kernel product equal, under torch.equal,
    the 1-row product of the same row (the split-K schedule and every
    sum's order follow K and N only, never M or the row's place in its
    tile)."""
    from .kernels import weight_only_linear as kwol
    out = kwol.weight_only_linear(a, q, s, swiglu=swiglu, use_kernel=True)
    return sum(bool(torch.equal(out[i], kwol.weight_only_linear(
        a[i:i + 1], q, s, swiglu=swiglu, use_kernel=True)[0]))
        for i in range(a.shape[0]))


# The int8 engine against a bf16 engine over the dequantized weights
# (the reference's own parity method, tests/test_serving.py:223): both
# compute the same weights, in another summation order (the W8A16
# kernel against cuBLAS), so greedy tokens may part only where the
# reference's top-2 logits nearly tie. A stream's first differing token
# must sit at a top-2 gap of the bf16 engine's logits no larger than
# this: the kernel route and the plain route of a 32-layer llama_7b
# step differ by up to 0.24 in a logit (chip_smoke's STEP_ATOL reading),
# and a flip needs the gap to close, so twice that.
INT8_GAP_LIMIT = 0.5


def int8_step_launches(L, verify_rows=None):
    """W8A16 launches of one int8 serving forward of L layers: qkv, o,
    the SwiGLU MLP and down a layer, then the lm head: one product, or
    `verify_rows` (K) products on the speculative engine's steps."""
    return 4 * L + (verify_rows or 1)


def top2_gap(logits):
    """top-1 minus top-2 of a [V] logit row, in f32."""
    t = torch.topk(logits.float(), 2).values
    return float(t[0] - t[1])


# ------------------------------------------------ the Transformer

# Transformer base (Vaswani et al. 2017, Table 3 "base"), chip_smoke.py's
# phase 11 and the card tests: batches of sentence pairs with
# default_rng lengths in [16, 128] padded to 128, sources masked by an
# additive f32 [B, 1, 1, S] mask of 0 / -1e9 (PaddleNLP's
# src_slf_attn_bias), beam search at TRANSFORMER_BEAM beams.
TRANSFORMER_MAXLEN = 128
TRANSFORMER_BEAM = 4


def transformer_lengths(n, seed):
    """n lengths, default_rng(seed).integers(16, 129)."""
    import numpy as np
    return [int(x) for x in np.random.default_rng(seed).integers(
        16, TRANSFORMER_MAXLEN + 1, n)]


def transformer_src_mask(lengths, S, device):
    """The additive source mask [B, 1, 1, S]: 0 at a valid key, -1e9 at
    padding."""
    valid = (torch.arange(S, device=device)[None, :]
             < torch.tensor(lengths, device=device)[:, None])
    return torch.where(valid, 0.0, -1e9).float()[:, None, None, :]


# Phase 11 (d) and the card tests: row 12's f32 bias forward at the beam
# search's decode shape (one query a row against the 128-key memory
# under the folded source mask) and at the encoder's (the training
# batch's source mask), and row 10's forward at one query against 64
# keys without ids (the decode step's self-attention at step 64).
TRANSFORMER_BIAS_CASES = {
    "transformer_decode": dict(B=64, Sq=1, Sk=128, hq=8, hk=8, d=64,
                               kind="beam_mask", causal=False),
    "transformer_encoder": dict(B=64, Sq=128, Sk=128, hq=8, hk=8, d=64,
                                kind="src_mask", causal=False),
}
TRANSFORMER_SEG_CASE = dict(B=64, Sq=1, Sk=64, h=8, d=64)


def seg_noid_pairs(q, k, v, scale):
    """Row 10's segment forward without ids (q and kv lengths that
    differ, no mask: the decode step's self-attention) against its plain
    version, the same function with every id equal (`_SegPlain`), on f32
    copies: [("o", kernel, plain, terms), ("lse", kernel, plain, None)]."""
    from .kernels import flash_attention as kfa
    o, lse = kfa.flash_attention_seg_fwd(q, k, v, None, None, False, scale)
    ones_q = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    ones_k = torch.ones(k.shape[:2], dtype=torch.int32, device=q.device)
    qf, kf, vf = (t.float() for t in (q, k, v))
    o_p = kfa._SegPlain.apply(qf, kf, vf, ones_q, ones_k, False, scale)
    lse_p = torch.logsumexp(kfa._seg_scores(qf, kf, ones_q, ones_k, False,
                                            scale), dim=-1)
    o_t = seg_flash_terms(qf, kf, vf, torch.zeros_like(qf), ones_q, ones_k,
                          False, scale)[0]
    return [("o", o, o_p, o_t), ("lse", lse, lse_p, None)]


def transformer_counters():
    """The attention kernels' wrappers (`encoder_counters`) and the fused
    cross-entropy kernels', by counter name: the Transformer phase holds
    every one of them."""
    from .kernels import cross_entropy as kce
    out = dict(encoder_counters())
    out["fused_cross_entropy"] = kce.fused_cross_entropy_fwd
    out["fused_cross_entropy_bwd"] = kce.fused_cross_entropy_bwd
    return out


def transformer_train_launches(L, mask):
    """Launches of one forward and backward of an L + L-layer Transformer
    at dropout 0, by `transformer_counters` name. Every float mask rides
    the bias route (a forward, dkv and dq for each of the encoder's self,
    the decoder's causal self and its cross attention); a bool source
    mask moves the encoder's self and the decoder's cross attention to
    the segment route (the forward, the delta pre-pass, dkv and dq), the
    target mask staying float."""
    if mask == "float":
        return {n: 3 * L for n in ("flash_attention_bias_fwd",
                                   "flash_attention_bias_dkv",
                                   "flash_attention_bias_dq")}
    if mask != "bool":
        raise ValueError(f"transformer_train_launches: unknown mask {mask!r}")
    out = {n: 2 * L for n in ("flash_attention_seg_fwd",
                              "flash_attention_delta",
                              "flash_attention_seg_dkv",
                              "flash_attention_seg_dq")}
    out.update({n: L for n in ("flash_attention_bias_fwd",
                               "flash_attention_bias_dkv",
                               "flash_attention_bias_dq")})
    return out


def transformer_decode_launches(L, step):
    """Launches of one beam-search decode step (0-based) of an L-layer
    decoder: the cross-attention's bias forward against the StaticCache a
    layer, and the self-attention's forward over the growing Cache a
    layer: the one-length kernel at the first step (Sq = Sk = 1), the
    segment kernel without ids after it (Sq = 1 < Sk)."""
    self_attn = "flash_attention_fwd" if step == 0 else \
        "flash_attention_seg_fwd"
    return {"flash_attention_bias_fwd": L, self_attn: L}


# Phase 11 (b): a 2-layer Transformer base at dropout 0, one train-mode
# forward and backward on the kernel route against `plain_routes()` from
# the same weights: |loss difference| / |loss| and the largest
# per-parameter relative L2 error of the grads. A k_proj bias's grad is
# 0 analytically (one constant added to every key's score leaves the
# softmax as it is): both routes read summation noise there, so its
# error is taken relative to the L2 of the same layer's q_proj bias
# grad. The loss read 0 on an H100 (NVIDIA H100 80GB HBM3, 700 W); its
# limit is about eighty f32 roundoffs. The grads are ill-conditioned in
# f32: at random weights the smoothed 37000-way loss is flat, and its
# grads are small sums of large cancelling terms. A first limit of 1e-4
# (twenty times the encoders' readings) failed at 4.28e-4. Against an
# f64 dense route on the same batch (attention as a dense softmax, the
# smoothed cross-entropy in f64; read once on the same card, T = 127)
# the plain f32 route itself lay up to 4.15e-4 (float masks) and
# 2.41e-4 (bool), the kernel route up to 2.41e-4 and 4.57e-4
# (decoder.layers.0/1.linear1). The grad limit is about twice the
# largest kernel-to-plain reading, 4.79e-4 (bool masks). The bool
# masks' run at T = S (a valid target row at a padded source index)
# is also held to the float masks' run on the kernel route, which
# masks the same keys additively, within the same two limits.
TRANSFORMER_LOSS_RTOL = 1e-5
TRANSFORMER_GRAD_RTOL = 1e-3
# Phase 11 (c): beam search on the kernel route against the same decode
# on `plain_routes()`. The routes' f32 log-probs differ by a few 1e-6,
# so a step's top-`beam` choice may differ only where two candidates of
# a batch row nearly tie: the token paths must be equal, or first differ
# at a step where some adjacent pair of that row's plain-route top
# beam + 1 totals (`beam_gaps`) lies within this many nats.
BEAM_GAP_LIMIT = 1e-3


def beam_gaps(log_probs, finished, logits, end_token, beam):
    """The smallest gap between adjacent totals among each batch row's
    top beam + 1 candidates of one beam-search step, as
    `nn.BeamSearchDecoder.step` scores them (`nn.decode.beam_totals`):
    log_probs, finished [nb, beam] before the step, logits [nb * beam,
    V] of the step. -> [nb]."""
    from .nn.decode import beam_totals
    total = beam_totals(log_probs, finished, logits, end_token)
    top = torch.topk(total, beam + 1, dim=-1).values
    return (top[:, :-1] - top[:, 1:]).min(dim=-1).values


# ---------------------------------------------------------------------------
# The conv slice (chip_smoke phase 12; tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

# Parameter counts phase 12 checks before it trains each model: bench.py's
# resnet50(num_classes=1000) (l.422-431), bench.py's UNet
# (block_out_channels (128, 256, 512, 512), cross_attention_dim 512,
# l.432-451) and `unet_sd15()`, the published SD 1.5 UNet (Rombach et al.
# 2022; the CompVis/stable-diffusion-v1-5 UNet config). Counted from the
# reference's models on the CPU; the port's layers are the reference's
# one for one.
RESNET50_PARAMS = 25_557_032
BENCH_UNET_PARAMS = 139_680_132
SD15_UNET_PARAMS = 859_520_964

# An f32 convolution on the card against the f64 convolution of the same
# values, as max|f32 - f64| / max|f64| (`tests/test_torch_cuda.py`): an
# f32 sum of K = C·kh·kw products rounds to a few 2^-24 of its largest
# terms, well under 1e-5 at the test's K = 576; TF32 products carry 10
# mantissa bits (2^-11 each), about 1e-3 on the same sum, so a conv that
# ran in TF32 misses this limit by two orders.
CONV_F32_RTOL = 2e-5

# Phase 12 (c): one B = 2 training step of phase 12's ResNet-50 and UNet
# on the card against the same step on the CPU, from the same weights
# and batch, and against an f64 copy of the step on the CPU. No kernel of
# the port runs here: cuDNN's convolutions (each algorithm its own
# summation order, FFT ones among them, full f32: the conv functionals
# turn TF32 off), cuBLAS's f32 products and the CPU's kernels compute
# the same sums in other orders, so the runs differ by f32 rounding
# alone, carried through 50 layers (ResNet-50) or 40-odd (the UNet).
# - the loss: card against CPU within CARD_CPU_LOSS_RTOL (read 9.1e-7
#   ResNet-50, 1.1e-7 UNet; H100 80GB HBM3, 700 W);
# - BatchNorm's running mean and variance after the step: card against
#   CPU, relative L2, within CARD_CPU_STAT_RTOL (read 1.1e-5);
# - each parameter's grad, relative L2 against the f64 run: the worst
#   tensor on the card within `card_grad_limit(e)`, e the CPU's own
#   worst f32 error there, and the card against the CPU within twice
#   that. A fixed limit cannot serve: at B = 2 ResNet-50's backward
#   cancels so deeply (each BatchNorm takes the batch mean out of its
#   grad, and the loss at init is 8.4) that the CPU's f32 grads lie 2.3%
#   (median) to 2.9% (worst) from f64 and the card's 2.8% to 3.8%,
#   while the UNet's lie 3e-6 (CPU) and 1.6e-5 (card) from it.
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_STAT_RTOL = 1e-4
CARD_CPU_NOISE_FACTOR = 4.0
CARD_CPU_GRAD_FLOOR = 1e-4


def card_grad_limit(cpu_err):
    """The card's worst grad error against the f64 run that phase 12 (c)
    allows, given the CPU's: CARD_CPU_NOISE_FACTOR times it, or
    CARD_CPU_GRAD_FLOOR (f32 rounding through 40-odd layers, the card's
    sums in other orders) where that is larger."""
    return max(CARD_CPU_NOISE_FACTOR * cpu_err, CARD_CPU_GRAD_FLOOR)


def forward_flops(model, *inputs):
    """The multiply-adds of one forward of `model` on `inputs`, counted
    as 2 FLOP each, over its products alone: every Conv1D/2D/3D (2 ·
    output elements · in / groups · prod(k)), transposed conv (2 · input
    elements · out / groups · prod(k)), Linear (2 · rows · in · out) and
    the UNet's CrossAttention scores and mix (2 · 2 · B · heads · Sq ·
    Sk · head_dim). Runs one forward without grad, through forward hooks
    (the meta device gives the count without the work)."""
    import math

    from .models.unet import CrossAttention
    from .nn.layer.common import Linear
    from .nn.layer.conv import _ConvNd

    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, _ConvNd):
            # weight [out, in / g, *k] or, transposed, [in, out / g, *k]:
            # each output (transposed: input) element takes shape[1] ·
            # prod(k) multiply-adds
            ref = args[0] if mod._transpose else out
            total[0] += 2 * ref.numel() * mod.weight.shape[1] \
                * math.prod(mod.kernel_size)
        elif isinstance(mod, Linear):
            total[0] += 2 * (args[0].numel() // mod.in_features) \
                * mod.in_features * mod.out_features
        elif isinstance(mod, CrossAttention):
            x = args[0]
            ctx = args[1] if len(args) > 1 and args[1] is not None else x
            total[0] += 2 * 2 * x.shape[0] * mod.heads * x.shape[1] \
                * ctx.shape[1] * mod.head_dim

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (_ConvNd, Linear, CrossAttention))]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]
