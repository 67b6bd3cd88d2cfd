"""The port's CUDA kernels against their plain PyTorch versions on the
card. Each test decides inside itself whether a card is present and
skips without one. This file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch, bypassing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -m cuda -q
"""
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import testing
from paddle_tpu_torch.kernels import _paged_split
from paddle_tpu_torch.kernels import cross_entropy as t_ce
from paddle_tpu_torch.kernels import flash_attention as t_fa
from paddle_tpu_torch.kernels import fused_norm_residual as t_fnr
from paddle_tpu_torch.kernels import paged_attention as t_pa
from paddle_tpu_torch.kernels import ragged_paged_attention as t_rpa
from paddle_tpu_torch.kernels import rms_norm as t_rms
from paddle_tpu_torch.kernels import swiglu as t_sw


def _max_rel(got, want):
    got = got.double().cpu()
    want = want.double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _within(got, want, atol, rtol=testing.BF16_RTOL):
    """bf16: |kernel - plain| <= atol + rtol * |plain| element by element
    (paddle_tpu_torch/testing.py), the plain version on f32 copies of the
    same bf16 inputs."""
    return testing.worst(got, want, atol, rtol) <= 1.0


def _within_terms(got, want, terms, dtype):
    """The kernels that round an intermediate before a second product
    (flash: P and dS; swiglu: dg and du): atol is TERM_FRAC of each
    element's own sum of |terms|, rtol 2^-7 on bf16 and 0 on f32."""
    dt = getattr(torch, dtype)
    rtol = testing.BF16_RTOL if dt == torch.bfloat16 else 0.0
    return _within(got, want, testing.TERM_FRAC[dt] * terms, rtol)


def _ragged_case(dtype, nh, kvh, d=64, page=16, ppmax=4, n_pages=12,
                 rows=((0, 5, 21), (5, 1, 7), (0, 0, 0), (6, 6, 6)), T=16):
    """Packed metadata mixing prefill chunks, a decode row, an idle slot
    and padding rows, on random pools (seeded numpy)."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(T, nh, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(kvh, n_pages, page, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(kvh, n_pages, page, d).astype(np.float32))
    pt = np.zeros((len(rows), ppmax), np.int32)
    nxt = 1
    for s, (_, _, kl) in enumerate(rows):
        for j in range(-(-max(kl, 1) // page)):
            pt[s, j] = nxt % n_pages or 1
            nxt += 1
    meta = [torch.tensor([r[i] for r in rows], dtype=torch.int32)
            for i in range(3)]
    return ([t.to(dtype).cuda() for t in (q, kp, vp)]
            + [m.cuda() for m in meta] + [torch.from_numpy(pt).cuda()])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# rms_norm's plan at its edges: row counts around its spreading and
# grid-walking thresholds, widths that need 1, 2, 4 and 5 warps a row and
# the largest row `supported` takes (48 KB); "noncontig" a strided view
RMS_ROWS = [1, 3, 4, 37, 129, 8191]
RMS_WIDTHS = [256, 2048, 4096, 5120, "max"]


def _rms_check(got, x, w, dt):
    """rms_norm's limits (chip_smoke.TOL): f32 5e-5 absolute, bf16 1e-5 +
    2^-7 |plain| against the plain version on f32 copies."""
    if dt == torch.float32:
        return _within(got, t_rms._plain(x, w, 1e-5), 5e-5, 0.0)
    return _within(got, t_rms._plain(x.float(), w, 1e-5), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", RMS_WIDTHS)
@pytest.mark.parametrize("rows", RMS_ROWS + ["noncontig"])
def test_rms_norm_matches_plain(dtype, H, rows):
    """The kernel against its plain version at the plan's edge rows and
    widths (every launch counted once), and a strided input."""
    _card()
    dt = getattr(torch, dtype)
    if H == "max":
        H = t_rms._MAX_ROW_BYTES * 8 // torch.finfo(dt).bits
    assert t_rms.supported((1, H), dt)
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.rand(H, generator=g, device="cuda") + 0.5
    if rows == "noncontig":
        x = torch.randn(16, 2 * H, generator=g, device="cuda").to(dt)[:, ::2]
        assert not x.is_contiguous()
    else:
        x = torch.randn(rows, H, generator=g, device="cuda").to(dt)
    before = t_rms.rms_norm.launches
    got = t_rms.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert t_rms.rms_norm.launches == before + 1
    assert _rms_check(got, x, w, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grad_route_matches_lean_route(dtype):
    """Under grad mode with x requiring grad the wrapper runs the kernel
    inside its autograd Function: the forward equals the lean route's
    (no_grad) bitwise, and the backward is the plain `_bwd`."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(129, 4096, generator=g, device="cuda").to(dt)
    w = torch.rand(4096, generator=g, device="cuda") + 0.5
    dy = torch.randn(129, 4096, generator=g, device="cuda").to(dt)
    with torch.no_grad():
        lean = t_rms.rms_norm(x, w, 1e-5)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = t_rms.rms_norm(xl, wl, 1e-5)
    assert y.grad_fn is not None and torch.equal(y.detach(), lean)
    y.backward(dy)
    dx, dw = t_rms._bwd(x, w, dy, 1e-5)
    assert torch.equal(xl.grad, dx) and torch.equal(wl.grad, dw)
    assert _rms_check(lean, x, w, dt)


# (rows, H, M). bf16: vector_tiles and scalar_edges run the mma.sync
# kernel in the forward (37 rows; H = 100 is not whole 16-byte vectors),
# wgmma_tiles the wgmma/TMA core with ragged row and column edges, partial
# gate/up boxes and 16 K steps; the backward's routes by the same test
# (chip_smoke.expected_swiglu_routes).
SWIGLU_FWD_CASES = [(37, 256, 688), (37, 100, 60), (1000, 1024, 1000)]
SWIGLU_BWD_CASES = [(77, 256, 688), (77, 100, 60), (1000, 1024, 1000)]
SWIGLU_IDS = ["vector_tiles", "scalar_edges", "wgmma_tiles"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,M", SWIGLU_FWD_CASES, ids=SWIGLU_IDS)
def test_swiglu_matches_plain(dtype, T, H, M):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(T, H, generator=g, device="cuda").to(dt)
    wgu = (0.05 * torch.randn(H, 2 * M, generator=g, device="cuda")).to(dt)
    got = t_sw.swiglu(a, wgu)
    if dt == torch.float32:
        assert _max_rel(got, t_sw._ref(a, wgu)) <= 1e-4
    else:
        assert _within(got, t_sw._ref(a.float(), wgu.float()), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(nh=8, kvh=2),
    dict(nh=4, kvh=4, d=128, page=8, ppmax=12,
         rows=((0, 9, 70), (9, 1, 33), (0, 0, 0), (10, 3, 3)))],
    ids=["gqa_d64_page16", "mha_d128_page8"])
def test_ragged_paged_attention_matches_plain(dtype, case):
    _card()
    dt = getattr(torch, dtype)
    args = _ragged_case(dt, **case)
    scale = 1.0 / math.sqrt(args[0].shape[-1])
    got = t_rpa.ragged_paged_attention(*args)
    assert torch.all(got[13:] == 0)              # padding rows
    if dt == torch.float32:
        want = t_rpa._dense_fallback(*args, scale)
        assert _max_rel(got, want) <= 2e-5
    else:
        # q pre-scaled in its own dtype, as kernel and plain version both
        # do; f32 from there on
        q, kp, vp = args[:3]
        want = t_rpa._dense_fallback((q * scale).float(), kp.float(),
                                     vp.float(), *args[3:], 1.0)
        assert _within(got, want, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_rms_norm_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(37, 256, generator=g, device="cuda").to(dt)
    r = torch.randn(37, 256, generator=g, device="cuda").to(dt)
    w = torch.rand(256, generator=g, device="cuda") + 0.5
    y, h = t_fnr.fused_add_rms_norm(x, r, w, 1e-5)
    # the plain version on f32 copies keeps the one low-precision step of
    # its float order: the norm reads h rounded to the stream dtype
    h_p = x.float() + r.float()
    y_p = t_rms._plain(h_p.to(dt).float(), w, 1e-5)
    if dt == torch.float32:
        assert _max_rel(y, y_p) <= 1e-5 and _max_rel(h, h_p) <= 1e-6
    else:
        # h is the bf16-rounded sum, as the unfused stream is
        assert torch.equal(h, x + r)
        assert _within(y, y_p, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,M", SWIGLU_BWD_CASES, ids=SWIGLU_IDS)
def test_swiglu_backward_matches_plain(dtype, T, H, M):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn(T, H, generator=g, device="cuda").to(dt)
    wgu = (0.05 * torch.randn(H, 2 * M, generator=g, device="cuda")).to(dt)
    do = torch.randn(T, M, generator=g, device="cuda").to(dt)
    a_, w_ = a.clone().requires_grad_(), wgu.clone().requires_grad_()
    t_sw.swiglu(a_, w_).backward(do)
    da_p, dw_p = t_sw._ref_bwd(a.float(), wgu.float(), do.float())
    da_t, dw_t = testing.swiglu_bwd_terms(a, wgu, do)
    assert _within_terms(a_.grad, da_p, da_t, dtype)
    assert _within_terms(w_.grad, dw_p, dw_t, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,hq,hk,d,causal", [
    (2, 128, 4, 4, 128, True), (1, 100, 4, 2, 64, False),
    (2, 192, 4, 1, 64, True), (1, 1000, 4, 4, 128, True)],
    ids=["mha_causal_d128", "gqa_full_d64_ragged", "mqa_causal_d64",
         "mha_causal_d128_ragged"])
def test_flash_attention_matches_plain(dtype, B, S, hq, hk, d, causal):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    q, do = (torch.randn(B, S, hq, d, generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, hk, d, generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = t_fa.flash_attention_bshd(*leaves, causal=causal)
    o.backward(do)
    # the plain version on f32 copies; GQA keeps the one bf16 step of
    # its float order, q pre-scaled in q's dtype
    qs, s = ((q * scale).to(dt), 1.0) if hq != hk else (q, scale)
    ref = [t.float().requires_grad_() for t in (qs, k, v)]
    o_p = t_fa._plain(*ref, causal, s)
    o_p.backward(do.float())
    terms = list(testing.flash_terms(*(r.detach() for r in ref),
                                     do.float(), causal, s))
    assert _within_terms(o, o_p, terms[0], dtype)
    if hq != hk:
        ref[0].grad.mul_(scale)          # through the pre-scaling
        terms[1] = terms[1] * scale
    for leaf, r, t in zip(leaves, ref, terms[1:]):
        assert _within_terms(leaf.grad, r.grad, t, dtype)
    _, lse = t_fa.flash_attention_fwd(qs, k, v, causal, s)
    assert _max_rel(lse, t_fa._plain_lse(qs.float(), k.float(), causal,
                                         s)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_train_step_launches_every_kernel(fused):
    """One llama_tiny bf16 TrainStep on the card goes through every
    training kernel: rms_norm L+1, fused_add_rms_norm L, swiglu
    forward L, its two backward launches L each, flash forward,
    backward and the backward's delta pre-pass L each — also under
    FLAGS_fused_transformer=0, which unfuses only the QKV projection on
    the card."""
    _card()
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(dtype="bfloat16", use_recompute=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    opt = topt.AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     weight_decay=0.1)
    step = TrainStep(model, opt, lambda i, l: model.loss(i, l))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64))).cuda()
    counters = (t_rms.rms_norm, t_fnr.fused_add_rms_norm, t_sw.swiglu,
                t_sw.swiglu_bwd_da, t_sw.swiglu_bwd_dw,
                t_fa.flash_attention_fwd, t_fa.flash_attention_bwd,
                t_fa.flash_attention_delta)
    before = [c.launches for c in counters]
    ptt.set_flags({"FLAGS_fused_transformer": fused})
    try:
        losses = [step(ids, ids).item() for _ in range(3)]
    finally:
        ptt.set_flags({"FLAGS_fused_transformer": True})
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [3 * (L + 1)] + [3 * L] * 7
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert model.model.norm.weight.dtype == torch.float32
    i = [id(p) for p in opt._parameter_list].index(
        id(model.model.norm.weight))
    assert opt._state[(i, "moment1")].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(testing.FUSED_CE_CASES))
def test_fused_cross_entropy_matches_plain(dtype, case):
    """chip_smoke.py's fused cross-entropy cases (`testing.FUSED_CE_CASES`:
    the 7B training slice's [8188, 32000] and a V = 30522 case whose rows
    take the scalar head and tail), with ignore_index rows, a label past
    the vocabulary and a negative one: loss, m and l within
    `testing.CE_LIMITS`, dx within CE_DX_FRAC of its row's |g| plus one
    rounding."""
    _card()
    dt = getattr(torch, dtype)
    logits, labels, g = testing.fused_ce_case(dtype=dt, seed=3,
                                              **testing.FUSED_CE_CASES[case])
    pairs, _ = testing.fused_ce_pairs(logits, labels, g)
    for name, got, ref, atol, rtol in pairs:
        assert testing.worst(got, ref, atol, rtol) <= 1.0, name
    # int32 labels take the same kernels
    loss32, _, _ = t_ce.fused_cross_entropy_fwd(logits, labels.int())
    assert torch.equal(loss32, pairs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["no remat", None, "nothing",
                                    "save_matmul_outputs", "dots"])
def test_remat_train_step_launches(policy):
    """A 2-layer llama_tiny at the full 32000 vocabulary, bf16, under
    FLAGS_use_fused_ce=1: each TrainStep launches every training kernel
    exactly as `testing.train_launches` counts for its remat policy (the
    recompute adds norms and the flash forward, and the SwiGLU forward
    unless save_matmul_outputs keeps its output), and the cross-entropy
    kernels once each."""
    _card()
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import llama as TL
    cfg = dataclasses.replace(
        TL.llama_tiny(dtype="bfloat16", use_recompute=policy != "no remat"),
        vocab_size=32000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    opt = topt.AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     weight_decay=0.1)
    step = TrainStep(model, opt, lambda i, l: model.loss(i, l),
                     remat_policy=None if policy == "no remat" else policy)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64))).cuda()
    want = testing.train_launches(cfg.num_hidden_layers, policy)
    counters = testing.train_counters()
    before = {n: c.launches for n, c in counters.items()}
    ptt.set_flags({"FLAGS_use_fused_ce": True})
    try:
        losses = [step(ids, ids).item() for _ in range(3)]
    finally:
        ptt.set_flags({"FLAGS_use_fused_ce": False})
    torch.cuda.synchronize()
    assert {n: c.launches - before[n] for n, c in counters.items()} == \
        {n: 3 * k for n, k in want.items()}
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


@pytest.mark.cuda
def test_fused_ce_flag_never_reaches_the_plain_route(monkeypatch):
    """Under FLAGS_use_fused_ce=1 a model loss over 32000 classes on the
    card runs the fused kernels, forward and backward; the plain route
    is patched to raise."""
    _card()
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.nn.functional import loss as floss

    def refuse(*args, **kwargs):
        raise AssertionError("the plain cross-entropy route ran")

    monkeypatch.setattr(floss, "_plain_cross_entropy", refuse)
    cfg = dataclasses.replace(
        TL.llama_tiny(dtype="bfloat16", use_recompute=True), vocab_size=32000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32))).cuda()
    before = (t_ce.fused_cross_entropy_fwd.launches,
              t_ce.fused_cross_entropy_bwd.launches)
    ptt.set_flags({"FLAGS_use_fused_ce": True})
    try:
        loss = model.loss(ids, ids)
        loss.backward()
    finally:
        ptt.set_flags({"FLAGS_use_fused_ce": False})
    torch.cuda.synchronize()
    assert (t_ce.fused_cross_entropy_fwd.launches - before[0],
            t_ce.fused_cross_entropy_bwd.launches - before[1]) == (1, 1)
    assert math.isfinite(loss.item())
    assert model.lm_head.grad is not None


@pytest.mark.cuda
def test_unfused_flag_still_launches_every_kernel():
    """FLAGS_fused_transformer=0 on the card: the serving step still goes
    through all three kernels (the flag unfuses only the QKV projection
    there)."""
    _card()
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = dict(TL.LlamaForCausalLM(cfg, device="cuda",
                                     generator=gen).state_dict())
    L, page = cfg.num_hidden_layers, 16
    kp = torch.zeros((L, cfg.kv_heads, 4, page, cfg.head_dim),
                     dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    i32 = dict(dtype=torch.int32, device="cuda")
    # one 5-token prefill in page 1, 3 padding rows on scratch page 0
    toks = torch.tensor([5, 6, 7, 8, 9, 0, 0, 0], **i32)
    pos = torch.tensor([0, 1, 2, 3, 4, 0, 0, 0], **i32)
    page_ids = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], **i32)
    pt = torch.tensor([[1, 0]], **i32)
    qs, ql, kl = (torch.tensor([v], **i32) for v in (0, 5, 5))
    kernels = (t_rms.rms_norm, t_sw.swiglu, t_rpa.ragged_paged_attention)
    before = [k.launches for k in kernels]
    ptt.set_flags({"FLAGS_fused_transformer": False})
    try:
        logits, _, _ = TL._ragged_step_paged(state, cfg, toks, pos, kp, vp,
                                             page_ids, pos.clone(), pt, qs,
                                             ql, kl)
    finally:
        ptt.set_flags({"FLAGS_fused_transformer": True})
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [2 * L + 1, L, L]
    assert bool(torch.isfinite(logits).all())


# Faults planted in a copy of the flash sources, each one edit in one
# kernel's body: (source, the kernel's definition, pattern, replacement,
# the readings function, the output whose check must then fail). The
# wgmma core of csrc/flash_wgmma.cu is what `testing.flash_readings`
# reads (the one-length bf16 route) and, with segment ids and two
# lengths, what `testing.seg_flash_readings` reads in bf16 and, in its
# 3xTF32 form, in f32 ("<label>_f32"), forward and backward (its
# "gqa_causal_pad" and "qpad_causal" cases are causal, "cross_len" holds
# a batch row with no valid key); the mma.sync kernels
# of csrc/flash_attention.cu run the bias route that
# `testing.bias_flash_readings` reads, so the old core stays guarded.
_FLASH_FAULTS = {
    # the segment forward drops each q tile's last kv tile (non-causal:
    # the last keys; causal: the diagonal)
    "fwd_drops_last_kv_tile": (
        "flash_wgmma.cu", "fwd_wgmma_body(",
        r"const int n_kv = \(kv_end \+ BN - 1\) / BN;",
        "const int n_kv = max(1, (kv_end + BN - 1) / BN - 1);",
        "seg_flash_readings", "o"),
    # the mma.sync (bias) forward drops each q tile's last kv tile
    "mma_fwd_drops_last_kv_tile": (
        "flash_attention.cu", "flash_fwd_mma_kernel(",
        r"const int n_kv = \(kv_end \+ TKV - 1\) / TKV;",
        "const int n_kv = max(1, (kv_end + TKV - 1) / TKV - 1);",
        "bias_flash_readings", "o"),
    # the segment dq counts the future keys of the diagonal tile (the dS
    # step both dq kernels share)
    "dq_diagonal_mask_off": (
        "flash_wgmma.cu", "dq_ds(",
        r"if \(kj >= Sk \|\| \(causal && kj > r0 \+ 8 \* hh\)\) p = 0\.f;",
        "if (kj >= Sk) p = 0.f;", "seg_flash_readings", "dq"),
    # the segment dk and dv count the earlier queries of the diagonal
    # tile (the P / dS step both dkv kernels share)
    "dkv_diagonal_mask_off": (
        "flash_wgmma.cu", "dkv_p_ds(",
        r"if \(qi >= Sq \|\| kj >= Sk \|\| \(causal && kj > qi\)\) "
        r"p = 0\.f;",
        "if (qi >= Sq || kj >= Sk) p = 0.f;", "seg_flash_readings", "dv"),
    # the mma.sync (bias) dk and dv skip the last q tile: the last keys
    # get none of it
    "dkv_skips_last_q_tile": (
        "flash_attention.cu", "flash_bwd_dkv_mma_kernel(",
        r"const int total = group \* n_q;",
        "const int total = group * max(0, n_q - 1);",
        "bias_flash_readings", "dv"),
    # the dkv plan skips a q tile it must visit: the own-position test
    # dropped, a tile of rows with no key of their own segment (P = 1 on
    # every key) is skipped where the segment ranges miss ("cross_len"'s
    # batch row with no valid key)
    "seg_dkv_plan_skips_rows_without_own_key": (
        "flash_wgmma.cu", "seg_dkv_plan(",
        r"bad \|= !\(row < Sk && seg_kv\[static_cast<size_t>\(b\) \* Sk "
        r"\+ row\] == v\);", "bad |= 0;", "seg_flash_readings", "dv"),
    # the wgmma forward drops each q tile's diagonal kv tile
    "wgmma_fwd_drops_diagonal_kv_tile": (
        "flash_wgmma.cu", "fwd_wgmma_body(",
        r"const int n_kv = \(kv_end \+ BN - 1\) / BN;",
        "const int n_kv = max(1, (kv_end + BN - 1) / BN - 1);",
        "flash_readings", "o"),
    # the wgmma dq counts the future keys of the diagonal tiles
    "wgmma_dq_diagonal_mask_off": (
        "flash_wgmma.cu", "dq_ds(",
        r"if \(kj >= Sk \|\| \(causal && kj > r0 \+ 8 \* hh\)\) p = 0\.f;",
        "if (kj >= Sk) p = 0.f;", "flash_readings", "dq"),
    # the wgmma dk and dv count the earlier queries of the diagonal tiles
    "wgmma_dkv_diagonal_mask_off": (
        "flash_wgmma.cu", "dkv_p_ds(",
        r"if \(qi >= Sq \|\| kj >= Sk \|\| \(causal && kj > qi\)\) "
        r"p = 0\.f;",
        "if (qi >= Sq || kj >= Sk) p = 0.f;", "flash_readings", "dv"),
    # the wgmma dk and dv skip the last q tile (of the last head)
    "wgmma_dkv_skips_last_q_tile": (
        "flash_wgmma.cu", "flash_bwd_dkv_wgmma_kernel(",
        r"const int total = group \* n_vis;",
        "const int total = group * max(0, n_vis - 1);", "flash_readings",
        "dv"),
    # the delta pre-pass drops each row's last 16-byte vector
    "delta_drops_last_vector": (
        "flash_wgmma.cu", "flash_delta_kernel(", r"  if \(row < rows\) \{",
        "  if (row < rows && c + V < D) {", "flash_readings", "delta"),
    # the f32 dkv drops the lo hi term of dV += P^T dO (P's lo parts
    # zeroed): the keys of the causal diagonal, which few rows see, keep
    # P's tf32 rounding
    "tf32_dkv_drops_lo_hi_in_dv": (
        "flash_wgmma.cu", "flash_bwd_dkv_tf32_kernel(",
        r"tf32_frag<BN>\(st, kk, ph\[kk\], pl\[kk\]\);",
        "tf32_frag<BN>(st, kk, ph[kk], pl[kk]); "
        "pl[kk][0] = pl[kk][1] = pl[kk][2] = pl[kk][3] = 0u;",
        "seg_flash_readings", "dv_f32"),
    # the f32 kernels' transposed tiles (dkv's Q^T and dO^T) keep the
    # rows in order, where the A fragments hand them over in vt_pos order
    "tf32_transpose_wrong_row_order": (
        "flash_wgmma.cu", "split_tile(",
        r"const int kap = vt_pos\(r\);", "const int kap = r;",
        "seg_flash_readings", "dk_f32"),
    # the f32 dq plans its walk at twice its kv tile: it skips tiles its
    # rows' keys lie in
    "tf32_dq_plan_at_wrong_tiles": (
        "flash_wgmma.cu", "flash_bwd_dq_tf32_kernel(",
        r"seg_plan<BM, BN, NT>\(", "seg_plan<BM, 2 * BN, NT>(",
        "seg_flash_readings", "dq_f32"),
}


def _readings_with_fault(tmp_path, source, fault, readings_fn):
    """Copy the package, plant `fault` = (anchor, pattern, replacement)
    in the copy's csrc/`source` (a path with a directory: relative to the
    package) (None: intact), build and run the copy's
    `testing.<readings_fn>()` in a subprocess; returns its readings."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = shutil.copytree(os.path.join(repo, "paddle_tpu_torch"),
                          tmp_path / "paddle_tpu_torch",
                          ignore=shutil.ignore_patterns("_build",
                                                        "__pycache__"))
    if fault is not None:
        anchor, pattern, repl = fault
        cu = pkg / source if "/" in source else pkg / "csrc" / source
        src = cu.read_text()
        at = src.index(anchor)
        body, n = re.subn(pattern, repl, src[at:], count=1)
        assert n == 1, f"{pattern}: the pattern is not in the kernel"
        cu.write_text(src[:at] + body)
    code = ("import json, sys\n"
            "import paddle_tpu_torch\n"
            "from paddle_tpu_torch import testing\n"
            "assert paddle_tpu_torch.__file__.startswith(sys.argv[1])\n"
            f"print(json.dumps(testing.{readings_fn}()))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=tmp_path, env=dict(os.environ,
                                                PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *_FLASH_FAULTS],
                         ids=["intact", *_FLASH_FAULTS])
def test_flash_check_fails_planted_faults(fault, tmp_path):
    """chip_smoke.py's flash check, run by `testing.flash_readings` (bf16
    causal MHA at the training shape [4, 2048, 16, 128], the wgmma core
    and its delta pre-pass), passes the kernels as written and fails
    each planted fault; the segment route's faults are read by
    `testing.seg_flash_readings`, the mma.sync kernels' by
    `testing.bias_flash_readings`. The package is copied, the fault
    planted in the copy's source, and the copy built and run in a
    subprocess. Prints each output's worst err/limit under the element
    limit (`terms`) and, for flash_readings, under a limit scaled by the
    tensor's max|plain| (`max`)."""
    _card()
    if fault is None:
        source, fix, readings_fn, out = None, None, "flash_readings", None
    else:
        source, anchor, pattern, repl, readings_fn, out = \
            _FLASH_FAULTS[fault]
        fix = (anchor, pattern, repl)
    readings = _readings_with_fault(tmp_path, source, fix, readings_fn)
    print(f"{readings_fn}, {fault or 'intact'}: {json.dumps(readings)}")
    terms = {k: r["terms"] if isinstance(r, dict) else r
             for k, r in readings.items()}
    if fault is None:
        assert all(r <= 1.0 for r in terms.values())
    else:
        assert terms[out] > 1.0


# Faults planted in a copy of csrc/cross_entropy.cu: (anchor, pattern,
# replacement, the output whose check must then fail).
_CE_FAULTS = {
    # the forward drops each row's last partial vector (the scalar tail
    # after its last whole 16 bytes): l misses those terms
    "drops_last_partial_vector": (
        "ce_fwd_kernel(",
        r"  for \(int j = tail \+ threadIdx\.x; j < V; j \+= kThreads\)\n"
        r"    online_add\(m, l, ptt::to_f\(xr\[j\]\)\);\n", "", "l"),
    # the forward gives ignore_index rows a loss
    "ignores_ignore_index": (
        "ce_fwd_kernel(",
        r"loss\[row\] = lbl == ignore_index \? 0\.f : logf\(l\) \+ m - xl;",
        "loss[row] = logf(l) + m - xl;", "loss"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *_CE_FAULTS],
                         ids=["intact", *_CE_FAULTS])
def test_fused_ce_check_fails_planted_faults(fault, tmp_path):
    """chip_smoke.py's fused cross-entropy check, run by
    `testing.fused_ce_readings` (bf16 at `testing.FUSED_CE_CASES`),
    passes the kernels as written and fails each planted fault."""
    _card()
    readings = _readings_with_fault(
        tmp_path, "cross_entropy.cu",
        None if fault is None else _CE_FAULTS[fault][:3],
        "fused_ce_readings")
    print(f"fused CE readings, {fault or 'intact'}: {json.dumps(readings)}")
    if fault is None:
        assert all(r <= 1.0 for r in readings.values())
    else:
        assert readings[_CE_FAULTS[fault][3]] > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(testing.PAGED_DECODE_CASES))
def test_paged_decode_attention_matches_plain(dtype, case):
    """chip_smoke.py's paged decode cases (`testing.PAGED_DECODE_CASES`):
    the bucketed engine's llama_7b decode (pool [32, 257, 16, 128],
    shuffled pages, lengths 17/100/300/700); generate's cache read
    through paginate_cache's strided views, at its own 192 tokens and at
    1024; GQA 32/8; d = 64 with GQA 8/2 and pages of 8; one sequence."""
    _card()
    dt = getattr(torch, dtype)
    ((_, args),) = testing.paged_decode_cases(dt, tags=(case,), seed=3)
    if testing.PAGED_DECODE_CASES[case][0] is testing.paged_decode_views_case:
        assert not args[1].is_contiguous()
    out, ref = testing.paged_decode_pair(*args)
    assert out.dtype == dt and out.shape == args[0].shape
    if dt == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert _within(out, ref, atol=1e-5)


@pytest.mark.cuda
def test_paged_decode_refuses_a_layout_it_does_not_take():
    """A CUDA pool whose d is not unit-stride raises; nothing is copied
    behind the caller's back."""
    _card()
    q, kp, vp, lens, pt = testing.paged_decode_case(lengths=(5, 9), nh=4,
                                                    kvh=4, d=64, ppseq=4)
    kt = kp.transpose(2, 3).contiguous().transpose(2, 3)
    vt = vp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="strides"):
        t_pa.paged_decode_attention(q, kt, vt, lens, pt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 3, 4])
def test_decode_rows_swiglu_and_rms_norm(dtype, rows):
    """SwiGLU and RMSNorm at the decode step's row counts (T = B), at
    llama_7b's widths."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(rows)
    H, M = 4096, 11008
    a = torch.randn(rows, 1, H, generator=g, device="cuda").to(dt)
    wgu = (0.02 * torch.randn(H, 2 * M, generator=g, device="cuda")).to(dt)
    w = torch.rand(H, generator=g, device="cuda") + 0.5
    y = t_sw.swiglu(a, wgu)
    n = t_rms.rms_norm(a, w, 1e-5)
    assert y.shape == (rows, 1, M) and n.shape == a.shape
    if dt == torch.float32:
        assert _max_rel(y, t_sw._ref(a, wgu)) <= 1e-4
        assert _max_rel(n, t_rms._plain(a, w, 1e-5)) <= 1e-5
    else:
        assert _within(y, t_sw._ref(a.float(), wgu.float()), atol=1e-4)
        assert _within(n, t_rms._plain(a.float(), w, 1e-5), atol=1e-5)


@pytest.mark.cuda
def test_generate_and_bucketed_engine_launch_every_kernel():
    """A llama_tiny bf16 generate on the card: rms_norm 2L+1 and swiglu
    L per forward (prefill and each decode step), paged decode attention
    L per decode step; then a bucketed engine: the same per prefill call
    and per decode step, paged decode L per decode step."""
    _card()
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    GenerationRequest)
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    L = cfg.num_hidden_layers
    kernels = (t_rms.rms_norm, t_sw.swiglu, t_pa.paged_decode_attention)
    before = [k.launches for k in kernels]
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 7))).cuda()
    out = model.generate(ids, max_new_tokens=5)
    torch.cuda.synchronize()
    assert out.shape == (2, 5) and out.dtype == torch.int32 and out.is_cuda
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [5 * (2 * L + 1), 5 * L, 4 * L]
    eng = ContinuousBatchingEngine(model, max_batch=2, max_seq=64,
                                   prefill_buckets=(8,), ragged=False,
                                   device="cuda")
    before = [k.launches for k in kernels]
    reqs = [GenerationRequest([3, 1, 4], max_new_tokens=6),
            GenerationRequest([1, 5], max_new_tokens=4)]
    eng.run(reqs)
    torch.cuda.synchronize()
    fwd = eng.decode_steps + sum(eng.prefill_calls.values())
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [fwd * (2 * L + 1), fwd * L, eng.decode_steps * L]
    assert [r.status for r in reqs] == ["served"] * 2
    assert [len(r.output) for r in reqs] == [6, 4]
    assert eng.pool.n_free == eng.pool.n_pages - 1


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "bucketed"])
def test_step_telemetry_adds_no_sync(ragged, monkeypatch):
    """A llama_tiny bf16 engine on the card with observability and
    request tracing armed: one xla.execute_seconds observation (> 0, from
    CUDA events) per tagged step, each no longer than its tick's host
    wall; against the kill switch with observability off, the same
    tokens and ticks and the same count of synchronizing CUDA runtime
    calls (torch.profiler's runtime events)."""
    _card()
    import time

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    GenerationRequest)
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.observability import device_events
    from paddle_tpu_torch.observability import metrics as om
    cfg = TL.llama_tiny(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5], list(range(1, 40))]
    tap = testing.ObservationTap(device_events._H_EXECUTE)
    monkeypatch.setattr(device_events, "_H_EXECUTE", tap)

    def steps(eng):
        return (eng.model_steps if ragged
                else eng.decode_steps + sum(eng.prefill_calls.values()))

    def run(armed):
        obs.enable(armed)
        om.reset()
        tap.seen.clear()
        eng = ContinuousBatchingEngine(model, max_batch=3, max_seq=128,
                                       max_chunk_tokens=16, ragged=ragged,
                                       request_trace=armed, device="cuda")
        reqs = [GenerationRequest(list(p), max_new_tokens=8)
                for p in prompts]
        for r in reqs:
            eng.add_request(r)
        eng.step()                       # warm-up tick, not profiled
        ticks = []                       # (host wall, steps in the tick)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            while eng.has_work:
                n0, t0 = steps(eng), time.perf_counter()
                eng.step()
                ticks.append((time.perf_counter() - t0, steps(eng) - n0))
        device_events.flush()
        n_sync = testing.sync_calls(prof.events())
        snap = om.snapshot()["histograms"]["xla.execute_seconds"]
        obs.enable(False)
        return eng, reqs, ticks, n_sync, snap, list(tap.seen)

    try:
        eng, reqs, ticks, n_sync, exe, seen = run(True)
        off, oreqs, oticks, o_sync, oexe, oseen = run(False)
    finally:
        obs.enable(False)
        om.reset()
    assert [r.output for r in reqs] == [r.output for r in oreqs]
    assert eng.ticks == off.ticks and len(ticks) == len(oticks)
    assert all(r.trace.snapshot()["status"] == "served" for r in reqs)
    assert oexe == {} and oseen == []
    print(f"ragged={ragged}: {n_sync} synchronizing calls in {len(ticks)} "
          f"ticks armed, {o_sync} in {len(oticks)} off")
    assert n_sync == o_sync and n_sync > 0
    tags = ({"serving.ragged_step": eng.model_steps} if ragged else
            {"serving.decode": eng.decode_steps,
             "serving.prefill": sum(eng.prefill_calls.values())})
    assert {k: v["count"] for k, v in exe.items()} == \
        {f"executable={t}": n for t, n in tags.items()}
    assert all(v > 0 for _, v in seen)
    if ragged:
        # one step a tick: the profiled ticks' readings, in order, each
        # within its tick's host wall
        walls = [w for w, n in ticks if n]
        assert all(n in (0, 1) for _, n in ticks)
        got = [v for _, v in seen][-len(walls):]
        assert all(v <= w for v, w in zip(got, walls)), (got, walls)


@pytest.mark.cuda
def test_speculative_engine_matches_kill_switch():
    """A llama_tiny bf16 ragged engine on the card with speculation armed
    and a drafter proposing the kill switch's own tokens (each third one
    corrupted): tokens equal to the kill switch's, drafts accepted and
    refuted, rms_norm 2L+1, swiglu L and ragged attention L launches per
    step, the pool free after the run."""
    _card()
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    GenerationRequest)
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 40, 90)]

    def run(spec, drafter=None):
        eng = ContinuousBatchingEngine(model, max_batch=3, max_seq=256,
                                       max_chunk_tokens=32,
                                       speculative=spec, device="cuda")
        if drafter:
            eng._draft_for_slot = drafter(eng)
        reqs = [GenerationRequest(list(p), max_new_tokens=24)
                for p in prompts]
        kernels = (t_rms.rms_norm, t_sw.swiglu, t_rpa.ragged_paged_attention)
        before = [k.launches for k in kernels]
        eng.run(reqs)
        torch.cuda.synchronize()
        L, n = cfg.num_hidden_layers, eng.model_steps
        assert [k.launches - b for k, b in zip(kernels, before)] == \
            [n * (2 * L + 1), n * L, n * L]
        assert eng.pool.n_free == eng.pool.n_pages - 1
        return eng, [r.output for r in reqs]

    _, off = run(False)
    refs = {tuple(p): o for p, o in zip(prompts, off)}

    def oracle(eng):
        def draft(i, budget):
            slot = eng.slots[i]
            req = slot.req
            k = min(slot.spec_k, budget,
                    req.max_new_tokens - slot.produced - 1)
            ref = refs[tuple(req.prompt)]
            m0 = len(req.output)
            return [(ref[m] + 1) % cfg.vocab_size if m % 3 == 2 else ref[m]
                    for m in range(m0, min(m0 + max(k, 0), len(ref)))]
        return draft

    eng, on = run(True, oracle)
    assert on == off
    assert 0 < eng.spec_accepted < eng.spec_drafted


# Faults planted in a copy of csrc/paged_attention.cu: (anchor, pattern,
# replacement).
_PAGED_FAULTS = {
    # every sequence drops the keys of its last, partial page
    "ignores_last_partial_page": (
        "paged_decode_kernel(",
        r"const int len = max\(0, min\(lengths\[b\], ppseq \* page\)\);",
        "const int len = max(0, min(lengths[b], ppseq * page)) / page * page;"),
    # every sequence reads page j / page of sequence 0's block table
    "reads_sequence_0_pages": (
        "paged_decode_kernel(",
        r"page_indices \+ static_cast<size_t>\(b\) \* ppseq",
        "page_indices"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *_PAGED_FAULTS],
                         ids=["intact", *_PAGED_FAULTS])
def test_paged_decode_check_fails_planted_faults(fault, tmp_path):
    """chip_smoke.py's paged decode check (`testing.paged_decode_readings`,
    bf16 at the bucketed engine's shape, lengths 17/100/300/700, none a
    page multiple) passes the kernel as written with room to spare (worst
    err/limit <= 0.5) and fails each planted fault by more than 10x."""
    _card()
    readings = _readings_with_fault(
        tmp_path, "paged_attention.cu",
        None if fault is None else _PAGED_FAULTS[fault],
        "paged_decode_readings")
    print(f"paged decode readings, {fault or 'intact'}: "
          f"{json.dumps(readings)}")
    if fault is None:
        assert readings["o"] <= 0.5
    else:
        assert readings["o"] > 10.0


# ---------------------------------------------- split-KV paged attention


def _split_lengths(split, page, end):
    """Key lengths at the split schedule's edges: 1, page - 1, page,
    split, split + 1, 2 * split and the block table's end."""
    return [1, page - 1, page, split, split + 1, 2 * split, end]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_keys", [32, None], ids=["split32", "default"])
@pytest.mark.parametrize("nh,kvh,d,page", [(8, 2, 64, 8), (4, 4, 128, 16),
                                           (8, 2, 128, 16), (4, 4, 64, 8),
                                           (4, 2, 64, 12)],
                         ids=["gqa_8_2_d64_p8", "mha_d128_p16",
                              "gqa_8_2_d128_p16", "mha_d64_p8",
                              "gqa_4_2_d64_p12"])
def test_paged_decode_split_edges_match_plain(dtype, split_keys, nh, kvh, d,
                                              page, monkeypatch):
    """Paged decode at lengths on the split schedule's edges (one
    sequence each; a small split and the wrapper's own), GQA and MHA,
    d 64 and 128, pages of 8 and 16, and of 12 (the page index by
    division, not shift)."""
    _card()
    if split_keys:
        monkeypatch.setattr(_paged_split, "SPLIT_KEYS", split_keys)
    dt = getattr(torch, dtype)
    ppseq = 48
    split = t_pa._split_pages(page, ppseq) * page
    lengths = _split_lengths(split, page, ppseq * page)
    args = testing.paged_decode_case(lengths=tuple(min(n, ppseq * page)
                                                   for n in lengths),
                                     nh=nh, kvh=kvh, d=d, page=page,
                                     ppseq=ppseq, dtype=dt, seed=5)
    out, ref = testing.paged_decode_pair(*args)
    if dt == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert _within(out, ref, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_keys", [64, None], ids=["split64", "default"])
@pytest.mark.parametrize("nh,kvh,d,page", [(8, 2, 64, 8), (4, 4, 128, 16),
                                           (8, 2, 128, 16), (4, 4, 64, 8)],
                         ids=["gqa_8_2_d64_p8", "mha_d128_p16",
                              "gqa_8_2_d128_p16", "mha_d64_p8"])
def test_ragged_split_edges_match_plain(dtype, split_keys, nh, kvh, d, page,
                                        monkeypatch):
    """Ragged paged attention with decode rows at lengths on the split
    schedule's edges, a chunk whose causal limit ends mid-split (its
    packed rows on tensor tiles in bf16), a fresh short prefill, an idle
    slot and padding rows (zeros); a small split and the wrapper's own."""
    _card()
    if split_keys:
        monkeypatch.setattr(_paged_split, "SPLIT_KEYS", split_keys)
    dt = getattr(torch, dtype)
    ppmax = 512 // page
    split = t_rpa._split_keys(ppmax * page)
    lengths = _split_lengths(split, page, ppmax * page)
    rows = [(0, 20, split + split // 2)]
    rows += [(20 + i, 1, n) for i, n in enumerate(lengths)]
    rows += [(0, 0, 0), (27, 3, 3)]
    T = 36
    args = testing.ragged_case(rows, T=T, nh=nh, kvh=kvh, d=d, page=page,
                               ppmax=ppmax, dtype=dt, seed=6)
    out, ref = testing.ragged_pair(*args)
    assert out.shape == args[0].shape and out.dtype == dt
    assert torch.all(out[30:] == 0)              # padding rows
    if dt == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert _within(out, ref, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(testing.RAGGED_CASES))
def test_ragged_cases_match_plain(dtype, case):
    """chip_smoke.py's ragged cases (`testing.RAGGED_CASES`: the serving
    step's mixed rows, the burst's decode-only steady state), GQA 32/8,
    d = 64 with GQA 8/2 and pages of 8, and the mixed rows read through
    paginate_cache's strided views in place."""
    _card()
    dt = getattr(torch, dtype)
    ((_, args),) = testing.ragged_cases(dt, tags=(case,), seed=3)
    if testing.RAGGED_CASES[case].get("views"):
        assert not args[1].is_contiguous()
    out, ref = testing.ragged_pair(*args)
    owned = torch.zeros(out.shape[0], dtype=torch.bool, device="cuda")
    for qs, ql in zip(args[3].tolist(), args[4].tolist()):
        owned[qs:qs + ql] = True
    assert torch.all(out[~owned] == 0)
    if dt == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert _within(out, ref, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_nonfinite_semantics(dtype):
    """Rows 9 and 13 on `testing.nonfinite_checks`: stale NaN keys and
    inf values past every length (and in the scratch and a free page)
    leave the output bitwise the clean pool's; a NaN key a sequence sees
    makes all its rows NaN and no other sequence's (the serving SLO
    layer quarantines on it)."""
    _card()
    got = testing.nonfinite_checks(t_rpa, t_pa, getattr(torch, dtype),
                                   "cuda")
    assert [label for label, ok in got if not ok] == []


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged_decode", "ragged_mixed",
                                    "ragged_decode_only"])
def test_paged_split_kernels_are_bitwise_repeatable(kernel):
    """Two runs of each split-KV kernel on the same inputs are bitwise
    equal (the merge reads every split back in split order; no float
    atomics), after a run on other inputs in between."""
    _card()
    if kernel == "paged_decode":
        args = testing.paged_decode_case(dtype=torch.bfloat16, seed=1)
        other = testing.paged_decode_case(dtype=torch.bfloat16, seed=2)
        fn = t_pa.paged_decode_attention
    else:
        tag = kernel[len("ragged_"):]
        ((_, args),) = testing.ragged_cases(torch.bfloat16, (tag,), seed=1)
        ((_, other),) = testing.ragged_cases(torch.bfloat16, (tag,), seed=2)
        fn = t_rpa.ragged_paged_attention
    a = fn(*args)
    fn(*other)
    b = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _partials_written(fn, args, n_split, R):
    """[n_split, R] bool: the (split, row) partials one launch of fn
    writes to its stream's split scratch (`_paged_split.buffers`; (m, l)
    pairs first), read as the l entries that are no longer the NaN the
    scratch was filled with."""
    fn(*args)                               # makes the stream's scratch
    torch.cuda.synchronize()
    dev = args[0].device
    _, part = _paged_split._buffers[
        (dev, torch.cuda.current_stream(dev).cuda_stream)]
    part.fill_(float("nan"))
    fn(*args)
    torch.cuda.synchronize()
    ml = part[:2 * n_split * R].view(n_split, R, 2)
    return ~torch.isnan(ml[..., 1]).cpu()


def _written_by_schedule(live, n_split):
    """[n_split, R] bool from each row's live splits: a row of one split
    writes its output directly, a row of n > 1 writes splits 0..n-1."""
    z = torch.arange(n_split)[:, None]
    return (live[None, :] > 1) & (z < live[None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("split_keys", [64, None], ids=["split64", "default"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(testing.RAGGED_CASES))
def test_ragged_schedule_is_the_kernels(case, dtype, split_keys,
                                        monkeypatch):
    """The schedule the CPU tests emulate (`_schedule`: tiles of packed
    rows, each tile's live splits) is the kernel's: the split partials a
    launch writes are exactly those of the rows whose tile has more than
    one live split, for its first n splits."""
    _card()
    if split_keys:
        monkeypatch.setattr(_paged_split, "SPLIT_KEYS", split_keys)
    dt = getattr(torch, dtype)
    ((_, args),) = testing.ragged_cases(dt, tags=(case,))
    q, kp = args[0], args[1]
    T, nh, _ = q.shape
    kvh, rep = kp.shape[0], nh // kp.shape[0]
    S = args[6].shape[1] * kp.shape[2]
    n_split = -(-S // t_rpa._split_keys(S))
    q_start, q_len, kv_len = (x.cpu() for x in args[3:6])
    live = torch.ones(T * nh, dtype=torch.long)
    for s, tiles in enumerate(t_rpa._schedule(q_len, kv_len, rep, S,
                                              dt == torch.bfloat16)):
        for r0, r1, _, _, n in tiles:
            for r in range(r0, r1):
                i, g = divmod(r, rep)
                heads = torch.arange(kvh) * rep + g
                live[(int(q_start[s]) + i) * nh + heads] = n
    assert n_split > 1 and int(live.max()) > 1
    got = _partials_written(t_rpa.ragged_paged_attention, args, n_split,
                            T * nh)
    assert torch.equal(got, _written_by_schedule(live, n_split))


@pytest.mark.cuda
@pytest.mark.parametrize("split_keys", [64, None], ids=["split64", "default"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["verify", "verify_gqa_32_8", "mixed"])
def test_ragged_row_tiles_are_decode_rows(case, dtype, split_keys,
                                          monkeypatch):
    """Every entry flagged in row_tiles: each row equals under
    torch.equal the same row launched alone as a q_len = 1 decode row,
    the launch writes exactly the split partials `_schedule(...,
    row_tiles)` predicts, and the output holds the plain version's
    limit."""
    _card()
    if split_keys:
        monkeypatch.setattr(_paged_split, "SPLIT_KEYS", split_keys)
    dt = getattr(torch, dtype)
    ((_, args),) = testing.ragged_cases(dt, tags=(case,))
    q, kp = args[0], args[1]
    T, nh, _ = q.shape
    kvh, rep = kp.shape[0], nh // kp.shape[0]
    S = args[6].shape[1] * kp.shape[2]
    B = args[3].shape[0]
    flags = torch.ones(B, dtype=torch.int32, device=q.device)
    same, n = testing.verify_bitwise(t_rpa.ragged_paged_attention, args,
                                     flags)
    assert same == n > 0
    n_split = -(-S // t_rpa._split_keys(S))
    q_start, q_len, kv_len = (x.cpu() for x in args[3:6])
    live = torch.ones(T * nh, dtype=torch.long)
    for s, tiles in enumerate(t_rpa._schedule(
            q_len, kv_len, rep, S, dt == torch.bfloat16, flags.cpu())):
        for r0, r1, _, _, nz in tiles:
            for r in range(r0, r1):
                i, g = divmod(r, rep)
                heads = torch.arange(kvh) * rep + g
                live[(int(q_start[s]) + i) * nh + heads] = nz
    got = _partials_written(
        lambda *a: t_rpa.ragged_paged_attention(*a, row_tiles=flags), args,
        n_split, T * nh)
    assert torch.equal(got, _written_by_schedule(live, n_split))
    out = t_rpa.ragged_paged_attention(*args, row_tiles=flags)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ref = t_rpa._dense_fallback((q * scale).float(), kp.float(),
                                args[2].float(), *args[3:], 1.0)
    if dt == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert _within(out, ref, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("split_keys", [64, None], ids=["split64", "default"])
@pytest.mark.parametrize("case", ["engine", "gqa_32_8", "b1",
                                  "generate_views"])
def test_paged_decode_schedule_is_the_kernels(case, split_keys, monkeypatch):
    """The split schedule `_split_plain` emulates is the kernel's: a
    sequence of n > 1 live splits (ceil(length / split), cut to the
    table) writes the partials of splits 0..n-1 for every q head, a
    sequence of one writes none."""
    _card()
    if split_keys:
        monkeypatch.setattr(_paged_split, "SPLIT_KEYS", split_keys)
    ((_, args),) = testing.paged_decode_cases(torch.bfloat16, tags=(case,))
    q, kp, _, lens, pt = args
    B, nh, _ = q.shape
    page, ppseq = kp.shape[2], pt.shape[1]
    sk = t_pa._split_pages(page, ppseq) * page
    n_split = -(-ppseq * page // sk)
    live = torch.clamp(-(-lens.long().cpu().clamp(0, ppseq * page) // sk),
                       min=1).repeat_interleave(nh)
    assert n_split > 1 and int(live.max()) > 1
    got = _partials_written(t_pa.paged_decode_attention, args, n_split,
                            B * nh)
    assert torch.equal(got, _written_by_schedule(live, n_split))


@pytest.mark.cuda
def test_ragged_refuses_a_layout_it_does_not_take():
    """A CUDA pool whose d is not unit-stride raises; nothing is copied
    behind the caller's back."""
    _card()
    q, kp, vp, *meta = testing.ragged_case([(0, 3, 9), (3, 1, 5)], T=8, nh=4,
                                           kvh=4, d=64, ppmax=4)
    kt = kp.transpose(2, 3).contiguous().transpose(2, 3)
    vt = vp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="strides"):
        t_rpa.ragged_paged_attention(q, kt, vt, *meta)


# Faults planted in a copy of csrc/paged_split.cuh, which both split-KV
# kernels share: (anchor, pattern, replacement).
_SPLIT_FAULTS = {
    # the merge takes split 1's partial without its rescale 2^(m_1 - M)
    "merge_drops_split_rescale": (
        "merge_rows(",
        r"\? 0\.f : exp2f\(ml\.x - M\) / L;",
        "? 0.f : (z == 1 ? 1.f : exp2f(ml.x - M)) / L;"),
    # every split but the first starts one page late
    "split_boundary_off_by_one_page": (
        "split_range(",
        r"k0 = z \* split_pages \* page;",
        "k0 = (z * split_pages + (z > 0)) * page;"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *_SPLIT_FAULTS],
                         ids=["intact", *_SPLIT_FAULTS])
def test_paged_split_check_fails_planted_faults(fault, tmp_path):
    """The split-KV checks (`testing.paged_split_readings`: paged decode
    at the bucketed engine's case, ragged attention at the serving
    step's mixed and decode-only cases, bf16) pass the kernels as written
    (worst err/limit <= 1; the output's one bf16 rounding alone reads up
    to 0.5) and fail each planted fault in the shared split schedule or
    merge, in both kernels."""
    _card()
    readings = _readings_with_fault(
        tmp_path, "paged_split.cuh",
        None if fault is None else _SPLIT_FAULTS[fault],
        "paged_split_readings")
    print(f"paged split readings, {fault or 'intact'}: "
          f"{json.dumps(readings)}")
    if fault is None:
        assert all(r <= 1.0 for r in readings.values())
    else:
        assert readings["decode"] > 1.0
        assert readings["ragged_mixed"] > 1.0


# ------------------------------------------- masked and packed attention


def _seg_case_checked(case, dtype):
    """The segment-id kernels against `_SegPlain` on f32 copies at one of
    `testing.ATTN_SEG_CASES`, element by element (terms rule; lse 1e-4 +
    1e-5 |plain|)."""
    dt = getattr(torch, dtype)
    kw = testing.ATTN_SEG_CASES[case]
    q, k, v, do, sq, skv = testing.attn_seg_case(**kw, dtype=dt)
    scale = q.shape[-1] ** -0.5
    # GQA keeps the one low-precision step of its float order: q
    # pre-scaled in q's dtype, the kernels at scale 1
    qs, s = ((q * scale).to(dt), 1.0) if q.shape[2] != k.shape[2] \
        else (q, scale)
    pairs, _ = testing.seg_flash_pairs(qs, k, v, do, sq, skv, kw["causal"],
                                       s)
    for label, got, ref, terms in pairs:
        if terms is None:
            assert testing.worst(got, ref, 1e-4, 1e-5) <= 1.0, label
        else:
            assert _within_terms(got, ref, terms, dtype), label


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa_causal_pad", "cross_len",
                                  "mqa_packed", "qpad_causal", "bert"])
def test_segment_flash_matches_plain(dtype, case):
    _card()
    _seg_case_checked(case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(testing.ATTN_SEG_CASES))
def test_segment_backward_matches_plain(dtype, case):
    """The segment route's backward as its autograd function runs it on
    the card (`_SegFlash`: the forward, the delta pre-pass, dkv and dq;
    bf16 on the wgmma core, f32 on its 3xTF32 form) against `_SegPlain`
    on f32 copies, at every `testing.ATTN_SEG_CASES` case: dq, dk and dv
    by the terms rule of testing.py."""
    _card()
    dt = getattr(torch, dtype)
    kw = testing.ATTN_SEG_CASES[case]
    q, k, v, do, sq, skv = testing.attn_seg_case(**kw, dtype=dt)
    scale = q.shape[-1] ** -0.5
    qs, s = ((q * scale).to(dt), 1.0) if q.shape[2] != k.shape[2] \
        else (q, scale)
    leaves = [t.detach().requires_grad_() for t in (qs, k, v)]
    t_fa._SegFlash.apply(*leaves, sq, skv, kw["causal"], s).backward(do)
    pairs, _ = testing.seg_flash_pairs(
        qs, k, v, do, sq, skv, kw["causal"], s,
        heads=8 if case == "packed_7b" else None)
    refs = {label: (ref, terms) for label, _, ref, terms in pairs}
    for label, leaf in zip(("dq", "dk", "dv"), leaves):
        ref, terms = refs[label]
        assert bool(torch.isfinite(leaf.grad).all()), label
        assert _within_terms(leaf.grad, ref, terms, dtype), label


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["one_length", "segment"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_backward_is_deterministic(route, d):
    """The f32 dkv and dq (3xTF32, no atomics) give bitwise-equal dq, dk
    and dv on two runs: the one-length route (GQA, causal) and the
    segment route (the "qpad_causal" ids, GQA)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    B, S, hq, hk = 2, 300, 4, 2
    q, do = (torch.randn(B, S, hq, d, generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn(B, S, hk, d, generator=g, device="cuda")
            for _ in range(2))
    sq = skv = None
    if route == "segment":
        kw = dict(testing.ATTN_SEG_CASES["qpad_causal"], d=d)
        q, k, v, do, sq, skv = testing.attn_seg_case(**kw,
                                                     dtype=torch.float32)
    o, lse = t_fa.flash_attention_seg_fwd(q, k, v, sq, skv, True, 1.0)

    def grads():
        if route == "one_length":
            return t_fa.flash_attention_bwd(q, k, v, o, lse, do, True, 1.0)
        args = (q, k, v, do, lse, t_fa.flash_attention_delta(o, do), sq,
                skv, True, 1.0)
        return (t_fa.flash_attention_seg_dq(*args),
                *t_fa.flash_attention_seg_dkv(*args))

    first, second = grads(), grads()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hk,d", [(4, 4, 64), (8, 2, 128)],
                         ids=["mha_d64", "gqa_d128"])
def test_segment_forward_without_ids_matches_plain(dtype, hq, hk, d):
    """The segment forward without ids (q and kv lengths that differ, no
    mask: the same kernels with ids off) against `_plain` on f32 copies:
    o by the terms rule, lse within 1e-4 + 1e-5 |plain|."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(2, 200, hq, d, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(2, 328, hk, d, generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = d ** -0.5
    if hq != hk:
        q, scale = (q * scale).to(dt), 1.0
    o, lse = t_fa.flash_attention_seg_fwd(q, k, v, None, None, False, scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    o_t = testing.flash_terms(qf, kf, vf, torch.zeros_like(qf), False,
                              scale)[0]
    assert _within_terms(o, t_fa._plain(qf, kf, vf, False, scale), o_t,
                         dtype)
    assert testing.worst(lse, t_fa._plain_lse(qf, kf, False, scale), 1e-4,
                         1e-5) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(testing.STATS_CASES))
def test_block_stats_matches_plain(dtype, case):
    """The block-stats kernel against `_dense_stats` on f32 copies at
    every `testing.STATS_CASES` case: m and l within
    `testing.STATS_LIMITS`, o by the terms rule, every output finite; the
    masked case holds -1e30 and -inf rows and keys and a fully masked row
    (11), which must give (-1e30, 0, 0)."""
    _card()
    dt = getattr(torch, dtype)
    args = testing.stats_case(**testing.STATS_CASES[case], dtype=dt)
    pairs = testing.block_stats_pairs(*args)
    for label, got, ref, atol, rtol in pairs:
        assert bool(torch.isfinite(got).all()), label
        assert testing.worst(got, ref, atol, rtol) <= 1.0, label
    if case == "masked":
        m, l, o = (p[1] for p in pairs)
        for b, h, row in ((0, 0, 3), (0, 1, 11), (1, 2, 11)):
            assert float(m[b, h, row]) == float(np.float32(-1e30))
            assert float(l[b, h, row]) == 0.0
            assert bool((o[b, row, h] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_stats_route(dtype):
    """bf16 block stats launch the wgmma core's stats kernel
    (`block_stats_wgmma_kernel`, csrc/flash_wgmma.cu), after the mask's
    pre-pass (`stats_mask_bits_kernel`) once at this masked case, and f32
    the SIMT kernel of csrc/block_attention.cu alone, one launch each a
    call, which `launches` counts once."""
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import block_attention as t_ba
    dt = getattr(torch, dtype)
    args = testing.stats_case(**testing.STATS_CASES["masked"], dtype=dt)
    t_ba.block_attention_fwd(*args[:5], args[5])
    torch.cuda.synchronize()
    before = t_ba.block_attention_fwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_ba.block_attention_fwd(*args[:5], args[5])
        torch.cuda.synchronize()
    assert t_ba.block_attention_fwd.launches == before + 1
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and ("block_stats" in e.key or "stats_mask" in e.key)]
    want = (("block_stats_wgmma_kernel", "stats_mask_bits_kernel")
            if dt == torch.bfloat16 else ("block_stats_simt_kernel",))
    assert len(names) == len(want), names
    for w in want:
        assert [c for key, c in names if w in key] == [1], (w, names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["masked", "alibi_gqa", "sdpa_float",
                                  "rel_table_bert"])
def test_bias_kernels_match_plain(dtype, case):
    """The bias kernels (forward, dkv, dq) against `_biased_plain_fwd` /
    `_biased_plain_bwd` on f32 copies at `testing.BIAS_CASES`, element by
    element under the flash rule (terms; lse 1e-4 + 1e-5 |plain|, +inf
    on the same rows); the masked case's rows with no valid key give o =
    0 and dq = 0 exactly."""
    _card()
    c = testing.bias_case(**testing.BIAS_CASES[case],
                          dtype=getattr(torch, dtype))
    pairs, (o, lse) = testing.bias_flash_pairs(
        c["q"], c["k"], c["v"], c["do"], c["kind"], c["param"], c["R"],
        c["padding_mask"], c["causal"], c["scale"])
    for label, got, ref, terms in pairs:
        if terms is None:
            assert testing.worst(got, ref, 1e-4, 1e-5) <= 1.0, label
        else:
            assert _within_terms(got, ref, terms, dtype), label
    if case == "masked":
        rows = torch.isinf(lse).transpose(1, 2)           # [B, Sq, Hq]
        assert bool(rows[2].all()) and bool(rows[0, 7].all())
        assert bool((o[rows] == 0).all())
        assert bool((pairs[2][1][rows] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["alibi_gqa_causal", "dense_padded_ragged"])
def test_biased_route_matches_plain(dtype, kind):
    """flash_attention_biased on the card (one bias forward launch, one
    dkv and one dq, no block-stats launch) against the same route on
    the CPU (its plain versions) on f32 copies: output and grads (q, k,
    v and a dense bias that requires grad), max |a - b| / max |b| within
    1e-4 (f32) or testing.SURFACE_RTOL (bf16: P and dS rounded before
    their products)."""
    _card()
    from paddle_tpu_torch.kernels import block_attention as t_ba
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    if kind == "alibi_gqa_causal":
        B, S, Sk, hq, hk, d, C = 2, 256, 256, 8, 2, 64, 128
        param = 2.0 ** -torch.arange(1, hq + 1, device="cuda").float()
        kw = dict(causal=True)
    else:
        B, S, Sk, hq, hk, d, C = 2, 200, 300, 4, 4, 128, 128
        param = 0.5 * torch.randn(B, 1, 1, Sk, generator=g, device="cuda")
        pm = torch.arange(Sk, device="cuda")[None] < torch.tensor(
            [[250], [300]], device="cuda")
        kw = dict(causal=False, padding_mask=pm)
    q, do = (torch.randn(B, S, hq, d, generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, hk, d, generator=g, device="cuda").to(dt)
            for _ in range(2))
    kind_name = "alibi" if kind.startswith("alibi") else "dense"

    def run(dev, cast):
        leaves = [t.detach().to(dev, cast).requires_grad_()
                  for t in (q, k, v)]
        p = param.detach().to(dev).requires_grad_(
            kind != "alibi_gqa_causal")
        kws = {n: (t.to(dev) if torch.is_tensor(t) else t)
               for n, t in kw.items()}
        out = t_fa.flash_attention_biased(*leaves, kind_name, p, chunk=C,
                                          **kws)
        out.backward(do.to(dev, out.dtype))
        grads = [t.grad for t in leaves]
        if p.requires_grad:
            grads.append(p.grad)
        return [out.detach()] + grads

    counters = testing.attention_counters()
    before = {n: c.launches for n, c in counters.items()}
    got = run("cuda", dt)
    grew = {n: c.launches - before[n] for n, c in counters.items()}
    assert grew == {n: int(n.startswith("flash_attention_bias"))
                    for n in counters}
    want = run("cpu", torch.float32)
    lim = 1e-4 if dt == torch.float32 else testing.SURFACE_RTOL
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _max_rel(a, b) <= lim
    assert t_ba.block_attention_fwd.launches == before[
        "block_attention_stats"]


@pytest.mark.cuda
def test_attention_surface_never_reaches_plain(monkeypatch):
    """On the card every route of the attention surface runs its kernels:
    the plain versions (`_plain`, `_SegPlain`, `_biased_plain_fwd`,
    `_biased_plain_bwd`, `_dense_stats`) are
    patched to raise, and sdpa (no mask, boolean padding mask, float
    mask), flash_attn_unpadded, MultiHeadAttention with a mask and cache,
    flash_attention_biased, block_attention_stats and a bert_tiny forward
    all run, forward and backward, with the launch counters advancing."""
    _card()
    from paddle_tpu_torch.kernels import block_attention as t_ba
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.nn.layer import MultiHeadAttention

    def refuse(*args, **kwargs):
        raise AssertionError("a plain attention route ran on the card")

    monkeypatch.setattr(t_fa, "_plain", refuse)
    monkeypatch.setattr(t_fa._SegPlain, "apply", refuse)
    monkeypatch.setattr(t_fa, "_biased_plain_fwd", refuse)
    monkeypatch.setattr(t_fa, "_biased_plain_bwd", refuse)
    monkeypatch.setattr(t_ba, "_dense_stats", refuse)
    counters = testing.attention_counters()
    before = {n: c.launches for n, c in counters.items()}
    g = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, D = 2, 128, 2, 64
    q = torch.randn(B, S, H, D, generator=g, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    pm = torch.arange(S, device="cuda")[None] < torch.tensor(
        [[100], [128]], device="cuda")
    outs = [TF.scaled_dot_product_attention(q, q, q),
            TF.scaled_dot_product_attention(q, q, q,
                                            attn_mask=pm[:, None, None]),
            TF.scaled_dot_product_attention(
                q, q, q, attn_mask=torch.where(pm, 0.0, -1e4)[:, None, None]),
            t_fa.flash_attention_biased(q, q, q, "alibi",
                                        torch.ones(H, device="cuda"),
                                        causal=True, chunk=64)]
    cu = torch.tensor([0, 50, 128, 256], device="cuda", dtype=torch.int32)
    flat = q.reshape(B * S, H, D)
    outs.append(TF.flash_attn_unpadded(flat, flat, flat, cu, cu, 128, 128,
                                       D ** -0.5, causal=True)[0])
    m, l, o = t_ba.block_attention_stats(q, q, q, None, 0.125)
    outs.append(o)
    sum(x.float().sum() for x in outs).backward()
    torch.cuda.synchronize()
    mha = MultiHeadAttention(128, 2, device="cuda").eval()
    x = torch.randn(B, 16, 128, generator=g, device="cuda")
    with torch.no_grad():
        mha(x, attn_mask=pm[:, None, None, :16])
        _, cache = mha(x, cache=mha.gen_cache(x))
        mha(x[:, :1], cache=cache)
        bert = TB.BertForMaskedLM(TB.bert_tiny(), device="cuda").eval()
        ids = torch.randint(1, 1024, (B, S), device="cuda")
        logits = bert(ids, attention_mask=pm.long())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(q.grad).all())
    grew = {n: c.launches - before[n] for n, c in counters.items()}
    assert grew["flash_attention_fwd"] >= 1 and grew["flash_attention_bwd"] >= 1
    # padding sdpa, unpadded, mha mask, the cache step (q 1 against 17
    # keys, no ids) and bert's 2 layers
    assert grew["flash_attention_seg_fwd"] == 2 + 1 + 1 + 2
    assert grew["flash_attention_seg_dkv"] == 2
    assert grew["flash_attention_seg_dq"] == 2
    # the delta pre-pass: the unmasked sdpa's backward and the two
    # segment backwards
    assert grew["flash_attention_delta"] == 1 + 2
    # float-mask sdpa and alibi: one bias forward, dkv and dq each; the
    # block-stats kernel only where it is called itself
    assert grew["flash_attention_bias_fwd"] == 2
    assert grew["flash_attention_bias_dkv"] == 2
    assert grew["flash_attention_bias_dq"] == 2
    assert grew["block_attention_stats"] == 1


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_do_not_take():
    _card()
    from paddle_tpu_torch.kernels import block_attention as t_ba
    x = torch.zeros(1, 64, 2, 96, device="cuda", dtype=torch.bfloat16)
    pm = torch.ones(1, 64, device="cuda")
    with pytest.raises(ValueError, match="does not take|do not take"):
        t_fa.flash_attention_bshd(x, x, x, padding_mask=pm, use_kernel=True)
    with pytest.raises(ValueError, match="no kernel"):
        t_fa.flash_attention_bshd(x, x, x, padding_mask=pm)
    with pytest.raises(ValueError, match="does not take"):
        t_ba.block_attention_stats(x, x, x, None, 0.1, use_kernel=True)
    y = torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="causal"):
        t_fa.flash_attention_bshd(y, y[:, :32], y[:, :32], causal=True)
    slopes = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="do not take"):
        t_fa.flash_attention_biased(x, x, x, "alibi", slopes,
                                    use_kernel=True)
    with pytest.raises(ValueError, match="no kernel"):
        t_fa.flash_attention_biased(x, x, x, "alibi", slopes)
    bias = t_fa._bias_args("alibi", slopes, None, None, y.shape, y.shape)
    with pytest.raises(ValueError, match="do not take"):
        t_fa.flash_attention_bias_fwd(y.cpu(), y.cpu(), y.cpu(), bias, True,
                                      0.125)
    with pytest.raises(ValueError, match="do not take"):
        t_fa.flash_attention_bias_fwd(y, y.float(), y, bias, True, 0.125)


# Faults planted in copies of csrc/flash_attention.cu and
# csrc/block_attention.cu: (source, anchor, pattern, replacement, the
# readings function, the output whose check must then fail).
_ATTN_FAULTS = {
    # the segment forward drops the segment test: every key counts
    "seg_fwd_segment_test_dropped": (
        "flash_wgmma.cu", "softmax_step(",
        r"      if \(kv\.x != sq\[hh\]\) x0 = kSegMask;\n"
        r"      if \(kv\.y != sq\[hh\]\) x1 = kSegMask;\n", "",
        "seg_flash_readings", "o"),
    # the visit plan treats touching segment ranges as disjoint: it skips
    # a tile whose largest segment is the block's smallest
    "seg_skip_touching_ranges": (
        "flash_wgmma.cu", "seg_plan(",
        r"!\(mx < qmm\[0\] \|\| mn > qmm\[1\]\)",
        "!(mx <= qmm[0] || mn > qmm[1])", "seg_flash_readings", "o"),
    # the plan skips in every block, also where a row may have no key of
    # its own segment (which must average every key)
    "seg_skip_without_own_key_test": (
        "flash_wgmma.cu", "seg_plan(",
        r"bad = !\(row < Sk && seg_kv\[static_cast<size_t>\(b\) \* Sk \+ "
        r"row\] == mn\);", "bad = 0;", "seg_flash_readings", "o"),
    # the f32 forward drops the Qlo Khi correction product of its scores
    "tf32_drops_lo_hi": (
        "flash_wgmma.cu", "flash_fwd_tf32_kernel(",
        r"hw::wgmma_tf32_rs\(sc, qlo\[kk\], kmajor_f32<BN>\(Kh, 0, kk\), 1\);",
        "(void)qlo;", "seg_flash_readings", "o_f32"),
    # the block-stats kernel (bf16: the wgmma core's stats mode) drops
    # the -5e29 threshold: a -1e30 bias is an ordinary score
    "stats_threshold_dropped": (
        "flash_wgmma.cu", "stats_scores(",
        r"      v0 = v0 && b0 > kMaskedBias;\n"
        r"      v1 = v1 && b1 > kMaskedBias;\n", "",
        "block_stats_readings", "l"),
    # dk and dv recompute P from the raw scores: the bias (with the
    # scale and the masks applied beside it) dropped
    "bias_dropped_in_dkv": (
        "flash_attention.cu", "flash_bwd_dkv_mma_kernel(",
        r"      bias_scores<QC / 8, true>\([^;]*;\n", "",
        "bias_flash_readings", "dv"),
    # a row with no valid key divides its zero sum by l = 0: NaN
    "l0_epilogue_nan": (
        "flash_attention.cu", "flash_fwd_mma_kernel(",
        r"if \(!\(l_r\[r\] > 0\.f\)\) \{ inv = 0\.f; lse_v = INFINITY; \}",
        "if (!(l_r[r] > 0.f)) { lse_v = INFINITY; }", "bias_flash_readings",
        "o"),
    # the GQA scale applied to q in its own dtype (splash's convention)
    # instead of to the f32 scores
    "gqa_scale_in_q_dtype": (
        "kernels/flash_attention.py", "def flash_attention_bias_fwd(",
        r"    q, k, v = \(_rows\(t\) for t in \(q, k, v\)\)\n",
        "    q, scale = (q * scale).to(q.dtype), 1.0\n"
        "    q, k, v = (_rows(t) for t in (q, k, v))\n",
        "bias_flash_readings", "lse"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["intact_seg", "intact_stats",
                                   "intact_bias", *_ATTN_FAULTS])
def test_attention_checks_fail_planted_faults(fault, tmp_path):
    """chip_smoke.py's segment-flash, block-stats and bias-flash checks
    (`testing.seg_flash_readings`, bf16 and f32; `testing.
    block_stats_readings`, `testing.bias_flash_readings`, bf16) pass the
    kernels as written and fail each planted fault."""
    _card()
    if fault.startswith("intact"):
        readings_fn = {"intact_seg": "seg_flash_readings",
                       "intact_stats": "block_stats_readings",
                       "intact_bias": "bias_flash_readings"}[fault]
        readings = _readings_with_fault(tmp_path, None, None, readings_fn)
    else:
        source, anchor, pattern, repl, readings_fn, out = \
            _ATTN_FAULTS[fault]
        readings = _readings_with_fault(tmp_path, source,
                                        (anchor, pattern, repl), readings_fn)
    print(f"{readings_fn}, {fault}: {json.dumps(readings)}")
    if fault.startswith("intact"):
        assert all(r <= 1.0 for r in readings.values())
    else:
        assert readings[out] > 1.0


# Every planted fault above as (source, anchor, pattern, replacement)
_PLANTED = {
    **{f"flash-{k}": v[:4] for k, v in _FLASH_FAULTS.items()},
    **{f"attn-{k}": v[:4] for k, v in _ATTN_FAULTS.items()},
    **{f"ce-{k}": ("cross_entropy.cu", *v[:3]) for k, v in _CE_FAULTS.items()},
    **{f"paged-{k}": ("paged_attention.cu", *v)
       for k, v in _PAGED_FAULTS.items()},
    **{f"split-{k}": ("paged_split.cuh", *v)
       for k, v in _SPLIT_FAULTS.items()},
}


@pytest.mark.parametrize("fault", list(_PLANTED))
def test_planted_fault_lies_in_its_source(fault):
    """Each planted fault's pattern is in its source past its anchor, as
    `_readings_with_fault` plants it (the sources alone: on any device),
    so that a kernel moved into a shared helper cannot leave a card test
    planting nothing."""
    source, anchor, pattern, _ = _PLANTED[fault]
    pkg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "paddle_tpu_torch")
    path = os.path.join(pkg, *([source] if "/" in source
                               else ["csrc", source]))
    with open(path) as f:
        src = f.read()
    assert anchor in src, f"{anchor}: the anchor is not in {source}"
    assert len(re.findall(pattern, src[src.index(anchor):])) >= 1, \
        f"{pattern}: the pattern is not in the kernel"


def _encoder_case(case):
    """(model, loss fn, attention route) of a 2-layer f32 encoder at a
    small width (2 heads of 64) on the card: "ernie" the one-length
    flash kernels, "bert_mask" a padding mask on the segment kernels
    (dropout 0), "bert_dropout" hidden and probs dropout 0.1 (the dense
    route)."""
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import ernie as TE
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S = 4, 256
    small = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=512, vocab_size=1024)
    ids = torch.randint(0, 1024, (B, S), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    if case == "ernie":
        model = TE.ErnieForPretraining(
            TE.ErnieConfig(hidden_dropout_prob=0.0, **small), device="cuda",
            generator=gen)
        return model, lambda: model.loss(ids, ids), "flash"
    p = 0.1 if case == "bert_dropout" else 0.0
    model = TB.BertForMaskedLM(
        TB.BertConfig(hidden_dropout_prob=p, attention_probs_dropout_prob=p,
                      max_position_embeddings=S, **small), device="cuda",
        generator=gen)
    mask = (torch.arange(S, device="cuda")[None]
            < torch.tensor([[S], [200], [77], [130]], device="cuda")).long()
    labels = torch.where(mask.bool(), ids, -100)
    return (model, lambda: model.loss(ids, labels, attention_mask=mask),
            "dense" if p else "segment")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ernie", "bert_mask", "bert_dropout"])
def test_encoder_training_on_card(case, monkeypatch):
    """A train-mode forward and backward of a small f32 encoder launches
    exactly `testing.encoder_launches(2, 1, route)` and no other
    attention kernel; on the kernel routes the loss and each grad agree
    with the plain versions (swapped in for the autograd Functions)
    within testing's encoder limits. Then two `TrainStep`s with AdamW
    take finite, falling losses."""
    _card()
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    model, loss_fn, route = _encoder_case(case)
    model.train()
    counters = testing.encoder_counters()
    before = {n: c.launches for n, c in counters.items()}

    def loss_and_grads():
        loss = loss_fn()
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    grew = {n: c.launches - before[n] for n, c in counters.items()}
    want = testing.encoder_launches(2, 1, route)
    assert grew == {n: want.get(n, 0) for n in counters}
    if route != "dense":
        monkeypatch.setattr(
            t_fa._FlashAttention, "apply",
            lambda q, k, v, causal, scale: t_fa._plain(q, k, v, causal,
                                                      scale))
        monkeypatch.setattr(t_fa._SegFlash, "apply", t_fa._SegPlain.apply)
        loss_p, grads_p = loss_and_grads()
        monkeypatch.undo()
        assert abs(loss_k - loss_p) <= testing.ENCODER_LOSS_RTOL * abs(loss_p)
        assert set(grads_k) == set(grads_p)
        for n, g in grads_p.items():
            err = ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
            assert err <= testing.ENCODER_GRAD_RTOL, (n, err)
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                     weight_decay=0.01)
    step = TrainStep(model, opt, loss_fn)
    losses = [step().item() for _ in range(3)]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_dropout_on_card():
    """The dropout stream on the card: one generator per device, reset
    by `core.seed`, equal to a generator seeded alike; a keep share
    within DROPOUT_SIGMAS of the binomial; kept elements upscaled."""
    _card()
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.nn import functional as TF
    x = torch.randn(16, 512, 768, device="cuda")
    core.seed(3)
    a = TF.dropout(x, 0.1)
    b = TF.dropout(x, 0.1)
    assert core.dropout_generator("cuda").device.type == "cuda"
    core.seed(3)
    assert torch.equal(TF.dropout(x, 0.1), a)
    assert not torch.equal(a, b)
    want = TF.dropout(x, 0.1,
                      generator=torch.Generator(device="cuda").manual_seed(3))
    assert torch.equal(a, want)
    keep = a != 0
    assert abs(testing.keep_share_sigmas(keep, 0.1)) <= testing.DROPOUT_SIGMAS
    torch.testing.assert_close(a[keep], x[keep] / 0.9)


# ------------------------------------------------------------ row 14: W8A16
# (K, N, SwiGLU): llama_7b's serving products (testing.W8A16_SHAPES),
# llama_tiny's (K = 688 is a multiple of 16 but not of the kernel's
# 64-row step) and a shape whose rows are not whole 16-byte vectors
# (K % 8, N % 16: the kernel's element-by-element loads)
W8A16_KN = [*testing.W8A16_SHAPES.values(), (688, 1376, True),
            (688, 256, False), (256, 1376, True), (100, 72, False),
            (100, 74, True)]
W8A16_KN_IDS = [*testing.W8A16_SHAPES, "tiny_gate_up", "tiny_down",
                "tiny_gu_k256", "scalar_edges", "scalar_edges_gu"]


def _w8a16_within(out, ref, atol):
    return testing.worst(out, ref, atol, testing.W8A16_LIMIT[1]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("M", testing.W8A16_ROWS)
@pytest.mark.parametrize("K,N,swiglu", W8A16_KN, ids=W8A16_KN_IDS)
def test_w8a16_matches_plain(M, K, N, swiglu):
    """Both epilogues at the engine's shapes and the ragged ones, per
    column scales (the serving rule), bf16."""
    _card()
    a, q, s = testing.w8a16_case(M, K, N)
    out, ref, atol = testing.w8a16_pair(a, q, s, swiglu=swiglu)
    torch.cuda.synchronize()
    assert out.shape == (M, N // 2 if swiglu else N)
    assert _w8a16_within(out, ref, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", testing.W8A16_LAYOUTS)
@pytest.mark.parametrize("swiglu", [False, True], ids=["plain", "swiglu"])
@pytest.mark.parametrize("M", [4, 130])
def test_w8a16_scale_layouts(layout, swiglu, M):
    """Per column, per tensor and per group of 64 and 128 rows."""
    _card()
    a, q, s = testing.w8a16_case(M, 4096, 2 * 1376, layout)
    out, ref, atol = testing.w8a16_pair(a, q, s, swiglu=swiglu)
    assert _w8a16_within(out, ref, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_w8a16_bias_round_scale_and_f16(dtype):
    """The plain epilogue's bias, incubate's float order (the scale
    rounded to the activation dtype first, as `incubate`'s
    `weight_only_linear` passes it) and f16 activations."""
    _card()
    dt = getattr(torch, dtype)
    for layout in ("column", "group64"):
        a, q, s = testing.w8a16_case(65, 4096, 4096, layout, dtype=dt)
        bias = (0.1 * torch.randn(4096, device="cuda")).to(dt)
        for round_scale in (False, True):
            sc = s.to(dt).float() if round_scale else s
            out, ref, atol = testing.w8a16_pair(a, q, sc, bias=bias)
            assert out.dtype == dt
            assert _w8a16_within(out, ref, atol), (layout, round_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("M", (130, *testing.W8A16_SWITCH_ROWS))
@pytest.mark.parametrize("K,N,swiglu", W8A16_KN, ids=W8A16_KN_IDS)
def test_w8a16_rows_are_independent(K, N, swiglu, M):
    """Row i of an M-row product is bitwise the 1-row product of row i:
    what keeps a speculative verify row bitwise a decode row under int8.
    M at both sides of every switch of the kernel's plan (the products'
    N, scratch or the in-register split merge, row groups) and 512."""
    _card()
    a, q, s = testing.w8a16_case(M, K, N)
    assert testing.w8a16_rows_independent(a, q, s, swiglu) == M


@pytest.mark.cuda
def test_w8a16_refuses_what_it_does_not_take():
    """On the card a dtype or scale layout the kernel does not take
    raises; nothing drops to the plain route."""
    _card()
    from paddle_tpu_torch.kernels import weight_only_linear as kwol
    a, q, s = testing.w8a16_case(4, 256, 128)
    with pytest.raises(ValueError):
        kwol.weight_only_linear(a.float(), q, s)
    _, q32, s32 = testing.w8a16_case(4, 256, 128, "group64")
    s32 = s32.repeat_interleave(2, dim=0)            # groups of 32 rows
    with pytest.raises(ValueError):
        kwol.weight_only_linear(a, q32, s32)
    with pytest.raises(ValueError):
        kwol.weight_only_linear(a, q, s[:, :64])


@pytest.mark.cuda
def test_int8_engine_refuses_f32_on_the_card():
    """An f32 model has no W8A16 kernel: the int8 engine raises
    NotImplementedError when it is built, not at its first tick."""
    _card()
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import llama as TL
    model = TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32"),
                                device="cuda")
    with pytest.raises(NotImplementedError, match="bf16 or f16"):
        ContinuousBatchingEngine(model, quantize="int8", device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "bucketed"])
def test_int8_engine_launches(ragged):
    """A llama_tiny bf16 int8 engine on the card: W8A16 4L + K launches a
    speculative ragged step (4L + 1 a bucketed forward), no SwiGLU
    kernel, rms_norm 2L+1 a forward; every stream served whole and the
    pool free."""
    _card()
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    GenerationRequest)
    from paddle_tpu_torch.kernels import weight_only_linear as kwol
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TL.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    eng = ContinuousBatchingEngine(model, max_batch=3, max_seq=256,
                                   max_chunk_tokens=32, quantize="int8",
                                   ragged=ragged, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [GenerationRequest(rng.integers(1, cfg.vocab_size, n).tolist(),
                              max_new_tokens=12) for n in (5, 40, 90)]
    kernels = (kwol.weight_only_linear, t_sw.swiglu, t_rms.rms_norm)
    before = [k.launches for k in kernels]
    eng.run(reqs)
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    if ragged:
        fwd = eng.model_steps
        per = testing.int8_step_launches(
            L, eng.max_draft_tokens + 1 if eng._spec else None)
    else:
        fwd = eng.decode_steps + sum(eng.prefill_calls.values())
        per = testing.int8_step_launches(L)
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [fwd * per, 0, fwd * (2 * L + 1)]
    assert all(len(r.output) == 12 for r in reqs)
    assert eng.pool.n_free == eng.pool.n_pages - 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(testing.TRANSFORMER_BIAS_CASES))
def test_transformer_bias_shapes_match_plain(case):
    """Row 12 at the Transformer phase's f32 shapes: one query a row
    against the 128-key memory under the beams' folded source mask (the
    decode's cross-attention, Sq = 1), and the encoder's 128 x 128 under
    the training batch's: forward, dkv and dq against the plain versions
    under the flash rule (lse 1e-4 + 1e-5 |plain|)."""
    _card()
    c = testing.bias_case(**testing.TRANSFORMER_BIAS_CASES[case],
                          dtype=torch.float32)
    pairs, _ = testing.bias_flash_pairs(
        c["q"], c["k"], c["v"], c["do"], c["kind"], c["param"], c["R"],
        c["padding_mask"], c["causal"], c["scale"])
    for label, got, ref, terms in pairs:
        if terms is None:
            assert testing.worst(got, ref, 1e-4, 1e-5) <= 1.0, label
        else:
            assert _within_terms(got, ref, terms, "float32"), label


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sk", [1, 2, 64, 127])
def test_one_query_forward_matches_plain(dtype, Sk):
    """Row 10's forward at one query, as the beam search's self-attention
    reaches it: Sk = 1 on the one-length kernel (the first step), Sk > 1
    on the segment kernel without ids (Sq = 1 < Sk), at the Transformer's
    [64, 1, 8, 64], against the plain version under the flash rule."""
    _card()
    dt = getattr(torch, dtype)
    kw = testing.TRANSFORMER_SEG_CASE
    gen = torch.Generator(device="cuda").manual_seed(Sk)
    q = torch.randn((kw["B"], 1, kw["h"], kw["d"]), generator=gen,
                    device="cuda").to(dt)
    k, v = (torch.randn((kw["B"], Sk, kw["h"], kw["d"]), generator=gen,
                        device="cuda").to(dt) for _ in range(2))
    scale = kw["d"] ** -0.5
    if Sk == 1:
        before = t_fa.flash_attention_fwd.launches
        o, lse = t_fa.flash_attention_fwd(q, k, v, False, scale)
        assert t_fa.flash_attention_fwd.launches == before + 1
        qf, kf, vf = (t.float() for t in (q, k, v))
        o_t = testing.flash_terms(qf, kf, vf, torch.zeros_like(qf), False,
                                  scale)[0]
        pairs = [("o", o, t_fa._plain(qf, kf, vf, False, scale), o_t),
                 ("lse", lse, t_fa._plain_lse(qf, kf, False, scale), None)]
    else:
        before = t_fa.flash_attention_seg_fwd.launches
        pairs = testing.seg_noid_pairs(q, k, v, scale)
        assert t_fa.flash_attention_seg_fwd.launches == before + 1
    for label, got, ref, terms in pairs:
        if terms is None:
            assert testing.worst(got, ref, 1e-4, 1e-5) <= 1.0, label
        else:
            assert _within_terms(got, ref, terms, dtype), label


def _conv_case(dtype=torch.float32, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((8, 64, 28, 28), generator=gen, device=device)
    w = 0.05 * torch.randn((64, 64, 3, 3), generator=gen, device=device)
    return x.to(dtype), w.to(dtype)


@pytest.mark.cuda
def test_f32_conv_runs_in_full_f32():
    """The port's f32 conv2d on the card, forward, input grad and weight
    grad, within testing.CONV_F32_RTOL of the f64 conv of the same
    values, with cuDNN's process-wide TF32 switch left on (its default):
    the conv functionals turn TF32 off around their own calls. The same
    call through torch.nn.functional.conv2d under the switch is printed
    beside it (-s)."""
    _card()
    from paddle_tpu_torch.nn import functional as TF
    x, w = _conv_case()
    g = torch.randn((8, 64, 28, 28), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        xs, ws = (t.clone().requires_grad_() for t in (x, w))
        out = TF.conv2d(xs, ws, padding=1)
        out.backward(g)
        lib = torch.nn.functional.conv2d(x, w, padding=1)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    xd, wd = (t.double().requires_grad_() for t in (x, w))
    ref = torch.nn.functional.conv2d(xd, wd, padding=1)
    ref.backward(g.double())
    errs = {"out": _max_rel(out, ref), "dx": _max_rel(xs.grad, xd.grad),
            "dw": _max_rel(ws.grad, wd.grad)}
    print(f"f32 conv vs f64: {errs}; F.conv2d under TF32: "
          f"{_max_rel(lib, ref):.3g} (limit {testing.CONV_F32_RTOL:g})")
    assert max(errs.values()) <= testing.CONV_F32_RTOL, errs


@pytest.mark.cuda
def test_cudnn_deterministic_flag_gives_bitwise_backwards():
    """With FLAGS_cudnn_deterministic set, two conv backwards of the
    same inputs give bitwise equal grads (cuDNN's deterministic
    algorithms; benchmark mode turned off while it is set)."""
    _card()
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nn import functional as TF
    x, w = _conv_case()
    torch.backends.cudnn.benchmark = True
    ptt.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        grads = []
        for _ in range(2):
            xs, ws = (t.clone().requires_grad_() for t in (x, w))
            TF.conv2d(xs, ws, padding=1, stride=2).sum().backward()
            grads.append((xs.grad, ws.grad))
        assert torch.equal(grads[0][0], grads[1][0])
        assert torch.equal(grads[0][1], grads[1][1])
    finally:
        ptt.set_flags({"FLAGS_cudnn_deterministic": False})
    assert not torch.backends.cudnn.deterministic
    assert torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False


def test_cudnn_flags_on_the_cpu():
    """set_flags takes FLAGS_cudnn_deterministic (its effect on torch's
    cuDNN switches needs no card) and still refuses the other cuDNN
    flags of the reference; the conv functionals read the flag from the
    environment too."""
    import os

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.nn.functional import conv as tconv
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.benchmark = True
        ptt.set_flags({"FLAGS_cudnn_deterministic": True})
        assert core.get_bool_flag("FLAGS_cudnn_deterministic")
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        ptt.set_flags({"FLAGS_cudnn_deterministic": False})
        assert not torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.benchmark
        for name in ("FLAGS_cudnn_exhaustive_search",
                     "FLAGS_cudnn_batchnorm_spatial_persistent",
                     "FLAGS_conv_workspace_size_limit"):
            with pytest.raises(NotImplementedError, match="not ported"):
                ptt.set_flags({name: True})
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        core._flags["FLAGS_cudnn_deterministic"] = False
    # the scope a conv runs under reads the flag, env first: on a CUDA
    # tensor it switches cuDNN for the call and restores it after
    fake = type("T", (), {"device": torch.device("cuda"),
                          "dtype": torch.float32})()
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    try:
        with tconv.cudnn_scope(fake):
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.allow_tf32
    finally:
        del os.environ["FLAGS_cudnn_deterministic"]
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == saved
