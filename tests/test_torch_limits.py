"""The element-limit rule of paddle_tpu_torch/testing.py on the CPU: the
sums of |terms| that scale the flash (plain, segment and bias) and
SwiGLU-backward limits bound
|plain| element by element, and equal it where no term can cancel (all
inputs that enter a sum with a sign made non-negative)."""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import testing
from paddle_tpu_torch.kernels import flash_attention as t_fa
from paddle_tpu_torch.kernels import swiglu as t_sw

from _torch_threads import one_torch_thread  # noqa: F401,E402


def _rand(rng, *shape, nonneg=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(np.abs(x) if nonneg else x)


def test_worst_ratio_and_non_finite():
    ref = torch.tensor([1.0, -2.0, 0.0])
    out = torch.tensor([1.5, -2.0, 0.25])
    # |err| / (atol + rtol |ref|): 0.5 / 1.5, 0, 0.25 / 1
    assert testing.worst(out, ref, 1.0, 0.5) == pytest.approx(1 / 3)
    assert testing.worst(out, ref, torch.tensor([0.5, 1.0, 0.125]),
                         0.0) == pytest.approx(2.0)
    assert testing.worst(torch.tensor([1.0, float("nan"), 0.0]), ref,
                         1.0, 0.0) == math.inf


@pytest.mark.parametrize("hq,hk,causal", [(4, 4, True), (4, 2, False),
                                          (4, 1, True)],
                         ids=["mha_causal", "gqa_full", "mqa_causal"])
@pytest.mark.parametrize("nonneg", [False, True], ids=["signed", "nonneg"])
def test_flash_terms_bound_plain(hq, hk, causal, nonneg):
    rng = np.random.default_rng(0)
    B, S, D = 2, 37, 16
    q = _rand(rng, B, S, hq, D).requires_grad_()
    k = _rand(rng, B, S, hk, D).requires_grad_()
    v = _rand(rng, B, S, hk, D, nonneg=nonneg).requires_grad_()
    do = _rand(rng, B, S, hq, D, nonneg=nonneg)
    scale = 0.3
    o = t_fa._plain(q, k, v, causal, scale)
    o.backward(do)
    terms = testing.flash_terms(q.detach(), k.detach(), v.detach(), do,
                                causal, scale)
    got = (o.detach(), q.grad, k.grad, v.grad)
    for name, g, t in zip(("o", "dq", "dk", "dv"), got, terms):
        assert t.shape == g.shape, name
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-6).all()), name
    if nonneg:
        # v >= 0 and do >= 0: o = P v and dv = P^T do hold no cancelling
        # term (max relative difference <= 1e-5)
        assert testing.worst(terms[0], o.detach(), 0.0, 1e-5) <= 1.0
        assert testing.worst(terms[3], v.grad, 0.0, 1e-5) <= 1.0


@pytest.mark.parametrize("nonneg", [False, True], ids=["signed", "nonneg"])
def test_swiglu_bwd_terms_bound_plain(nonneg):
    rng = np.random.default_rng(1)
    T, H, M = 13, 24, 20
    a = _rand(rng, T, H, nonneg=nonneg)
    w = 0.2 * _rand(rng, H, 2 * M, nonneg=nonneg)
    do = _rand(rng, T, M, nonneg=nonneg)
    da, dw = t_sw._ref_bwd(a, w, do)
    da_t, dw_t = testing.swiglu_bwd_terms(a, w, do)
    for name, g, t in (("da", da, da_t), ("dw", dw, dw_t)):
        assert t.shape == g.shape, name
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-6).all()), name
        if nonneg:
            # a, w, do >= 0 make g, u, dg and du >= 0: nothing cancels
            # (max relative difference <= 1e-5)
            assert testing.worst(t, g, 0.0, 1e-5) <= 1.0, name


@pytest.mark.parametrize("hq,hk,causal,Sk", [(4, 4, False, 37),
                                             (4, 2, True, 37),
                                             (2, 1, False, 37),
                                             (2, 2, False, 51)],
                         ids=["mha_full", "gqa_causal", "mqa_full",
                              "cross_len_empty_row"])
def test_seg_flash_terms_bound_plain(hq, hk, causal, Sk):
    """The segment-id terms bound the plain version's outputs element by
    element (two padded batch rows; with Sk != S the second has no valid
    key, whose backward recomputes P = 1)."""
    rng = np.random.default_rng(2)
    B, S, D = 2, 37, 16
    q = _rand(rng, B, S, hq, D).requires_grad_()
    k = _rand(rng, B, Sk, hk, D).requires_grad_()
    v = _rand(rng, B, Sk, hk, D).requires_grad_()
    do = _rand(rng, B, S, hq, D)
    pm = torch.arange(Sk)[None, :] < torch.tensor([[30], [Sk]])
    if Sk != S:
        pm[1] = False
    sq, skv = t_fa.padding_segments(pm, S, Sk)
    o = t_fa._SegPlain.apply(q, k, v, sq, skv, causal, 0.3)
    o.backward(do)
    terms = testing.seg_flash_terms(q.detach(), k.detach(), v.detach(), do,
                                    sq, skv, causal, 0.3)
    got = (o.detach(), q.grad, k.grad, v.grad)
    for name, g, t in zip(("o", "dq", "dk", "dv"), got, terms):
        assert t.shape == g.shape, name
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-6).all()), name


@pytest.mark.parametrize("kind,causal,Sk", [("alibi", True, 37),
                                             ("rel_table", False, 51),
                                             ("dense", True, 51)],
                         ids=["alibi_causal", "rel_table_full",
                              "dense_causal_empty_rows"])
@pytest.mark.parametrize("nonneg", [False, True], ids=["signed", "nonneg"])
def test_bias_flash_terms_bound_plain(kind, causal, Sk, nonneg):
    """The bias kernels' terms (`bias_flash_terms`, over KV chunks) bound
    the plain version's outputs element by element, GQA, with a padding
    mask and, for the dense bias, a -inf row and a batch row with no
    valid key (its terms and outputs are 0)."""
    rng = np.random.default_rng(3)
    B, S, hq, hk, D = 2, 37, 4, 2, 16
    q, k = _rand(rng, B, S, hq, D), _rand(rng, B, Sk, hk, D)
    v = _rand(rng, B, Sk, hk, D, nonneg=nonneg)
    do = _rand(rng, B, S, hq, D, nonneg=nonneg)
    R, pm = None, None
    if kind == "alibi":
        param = testing.alibi_slopes(hq, device="cpu")
    elif kind == "rel_table":
        R, param = 5, 0.5 * _rand(rng, hq, 11)
    else:
        param = 0.5 * _rand(rng, B, 1, S, Sk)
        param[0, 0, 4] = -float("inf")
        pm = torch.arange(Sk)[None, :] < torch.tensor([[40], [0]])
    args = (kind, param, R, causal, 0.3, pm, 16)
    o, lse = t_fa._biased_plain_fwd(q, k, v, *args)
    grads = t_fa._biased_plain_bwd(q, k, v, o, lse, do, *args)
    terms = testing.bias_flash_terms(q, k, v, do, o, lse, kind, param, R,
                                     causal, 0.3, pm)
    for name, g, t in zip(("o", "dq", "dk", "dv"), (o,) + grads, terms):
        assert t.shape == g.shape, name
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-6).all()), name
    if nonneg:
        assert testing.worst(terms[0], o, 0.0, 1e-5) <= 1.0
        assert testing.worst(terms[3], grads[2], 0.0, 1e-5) <= 1.0
    if pm is not None:
        assert bool(torch.isinf(lse[1]).all()) and bool(
            torch.isinf(lse[0, :, 4]).all())
        assert float(terms[0][1].abs().max()) == 0.0


def test_case_lengths():
    lengths = testing.bert_lengths()
    assert len(lengths) == 16 and lengths[0] == 512
    assert all(64 <= n <= 512 for n in lengths)
    docs = testing.packed_lengths()
    assert sum(docs) == 8192 and all(n >= 1 for n in docs)
    assert all(128 <= n <= 2048 for n in docs[:-1])


def test_transformer_cases_and_launch_counts():
    """The Transformer phase's lengths, source masks and launch counts."""
    lengths = testing.transformer_lengths(64, 0)
    assert len(lengths) == 64 and all(16 <= n <= 128 for n in lengths)
    assert lengths == [int(n) for n in np.random.default_rng(0).integers(
        16, 129, 64)]
    mask = testing.transformer_src_mask([3, 5], 5, "cpu")
    assert mask.shape == (2, 1, 1, 5) and mask.dtype == torch.float32
    assert mask[0, 0, 0].tolist() == [0.0, 0.0, 0.0, -1e9, -1e9]
    assert testing.transformer_train_launches(2, "float") == {
        "flash_attention_bias_fwd": 6, "flash_attention_bias_dkv": 6,
        "flash_attention_bias_dq": 6}
    assert testing.transformer_train_launches(2, "bool") == {
        "flash_attention_seg_fwd": 4, "flash_attention_delta": 4,
        "flash_attention_seg_dkv": 4, "flash_attention_seg_dq": 4,
        "flash_attention_bias_fwd": 2, "flash_attention_bias_dkv": 2,
        "flash_attention_bias_dq": 2}
    with pytest.raises(ValueError):
        testing.transformer_train_launches(2, "dense")
    assert testing.transformer_decode_launches(6, 0) == {
        "flash_attention_bias_fwd": 6, "flash_attention_fwd": 6}
    assert testing.transformer_decode_launches(6, 5) == {
        "flash_attention_bias_fwd": 6, "flash_attention_seg_fwd": 6}
    names = set(testing.transformer_counters())
    assert {"fused_cross_entropy", "fused_cross_entropy_bwd",
            "flash_attention_seg_fwd", "flash_attention_bias_fwd"} <= names


def test_beam_gaps_match_brute_force():
    """beam_gaps scores a step as BeamSearchDecoder does (a finished beam
    extends only with the end token at 0) and returns each row's
    smallest gap among its top beam + 1 totals."""
    rng = np.random.default_rng(3)
    nb, beam, V = 3, 2, 5
    lp = torch.from_numpy(rng.standard_normal((nb, beam)).astype(np.float32))
    fin = torch.tensor([[False, True], [False, False], [True, True]])
    logits = torch.from_numpy(rng.standard_normal((nb * beam, V)).astype(
        np.float32))
    got = testing.beam_gaps(lp, fin, logits, 1, beam)
    step = torch.log_softmax(logits, -1).reshape(nb, beam, V)
    for b in range(nb):
        cands = []
        for j in range(beam):
            for t in range(V):
                s = (0.0 if t == 1 else -1e9) if fin[b, j] else \
                    float(step[b, j, t])
                cands.append(float(lp[b, j]) + s)
        top = sorted(cands, reverse=True)[:beam + 1]
        want = min(top[i] - top[i + 1] for i in range(beam))
        assert math.isclose(float(got[b]), want, rel_tol=1e-5,
                            abs_tol=1e-4)


def test_card_grad_limit_scales_the_cpus_error():
    """Phase 12 (c)'s grad limit: NOISE_FACTOR times the CPU's own f32
    error against the f64 run, never under the floor."""
    f, floor = testing.CARD_CPU_NOISE_FACTOR, testing.CARD_CPU_GRAD_FLOOR
    assert testing.card_grad_limit(0.0) == floor
    assert testing.card_grad_limit(3e-6) == floor
    assert testing.card_grad_limit(0.029) == pytest.approx(f * 0.029)
