"""The port's CUDA kernels against their plain PyTorch versions on the
card. Each test decides inside itself whether a card is present and
skips without one. This file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch, bypassing tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -m cuda -q
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import ragged_paged_attention as t_rpa
from paddle_tpu_torch.kernels import rms_norm as t_rms
from paddle_tpu_torch.kernels import swiglu as t_sw


def _max_rel(got, want):
    got = got.double().cpu()
    want = want.double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


# bf16: |kernel - plain| <= atol + BF16_RTOL * |plain| element by element,
# where the plain version runs on f32 copies of the same bf16 inputs and
# keeps its f32 result; the kernel rounds its f32 result to bf16 once
# (unit roundoff 2^-8), so BF16_RTOL is two roundoffs and atol covers
# the f32 summation order near zero
BF16_RTOL = 2.0 ** -7


def _within(got, want, atol, rtol=BF16_RTOL):
    got = got.double().cpu()
    want = want.double().cpu()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(37, 256, generator=g, device="cuda").to(dt)
    w = torch.rand(256, generator=g, device="cuda") + 0.5
    got = t_rms.rms_norm(x, w, 1e-5)
    if dt == torch.float32:
        assert _max_rel(got, t_rms._plain(x, w, 1e-5)) <= 1e-5
    else:
        assert _within(got, t_rms._plain(x.float(), w, 1e-5), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,M", [(256, 688), (100, 60)],
                         ids=["vector_tiles", "scalar_edges"])
def test_swiglu_matches_plain(dtype, H, M):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(37, H, generator=g, device="cuda").to(dt)
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
