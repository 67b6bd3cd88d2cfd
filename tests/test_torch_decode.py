"""Port decode path (paddle_tpu_torch) against the JAX package, on the
CPU: the paged decode attention's plain version, the contiguous-cache
forward, the paged decode step, `LlamaForCausalLM.generate` and the
serving engine's bucketed regime (ragged=False), from seeded numpy
inputs and weights carried by `state_from_jax`, llama_tiny in fp32.
Tolerances: attention 1e-5, logits 1e-4, caches and pools 1e-5; tokens
identical. The JAX engine runs with slo=False, speculative=False,
request_trace=False (kill switches that are bitwise in the reference)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.kernels import paged_attention as j_pa
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import gateway as t_gw
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.kernels import paged_attention as t_pa
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax

from _torch_threads import one_torch_thread  # noqa: F401,E402


def _pair(seed=0, kvh=None):
    paddle.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(
        dtype="float32", use_recompute=False, num_key_value_heads=kvh))
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TL.llama_tiny(dtype="float32", num_key_value_heads=kvh)
    tm = TL.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, cfg, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def mha():
    return _pair()


@pytest.fixture(scope="module")
def gqa():
    return _pair(seed=3, kvh=2)


def _jstate(jm):
    return {k: v.data for k, v in jm.state_dict().items()}


@pytest.fixture
def flag():
    """Set FLAGS_fused_transformer in both packages; restored after."""
    def set_(on):
        paddle.set_flags({"FLAGS_fused_transformer": on})
        ptt.set_flags({"FLAGS_fused_transformer": on})
    yield set_
    set_(True)


# ---------------- the kernel's plain version --------------------------------

def _paged_case(B, nh, kvh, d, page, ppseq, lengths, seed=0):
    """Random pool with a shuffled block table: sequence b owns
    ceil(lengths[b] / page) distinct pages in random order."""
    rng = np.random.RandomState(seed)
    n_pages = B * ppseq + 1
    q = rng.randn(B, nh, d).astype(np.float32)
    kp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    vp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    perm = rng.permutation(n_pages - 1) + 1
    pt = np.zeros((B, ppseq), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        used = -(-n // page)
        pt[b, :used] = perm[nxt:nxt + used]
        nxt += used
    return q, kp, vp, np.asarray(lengths, np.int32), pt


@pytest.mark.parametrize("nh,kvh,d,page,lengths", [
    (4, 4, 64, 16, (1, 64, 37)),
    (4, 2, 128, 8, (64, 1, 13)),
    (8, 2, 64, 16, (50, 64, 1))],
    ids=["mha_d64", "gqa_4_2_d128", "gqa_8_2_d64"])
def test_paged_decode_plain_matches_jax(nh, kvh, d, page, lengths):
    """Lengths 1 and full (ppseq * page), shuffled page table."""
    ppseq = 64 // page
    q, kp, vp, lens, pt = _paged_case(3, nh, kvh, d, page, ppseq, lengths)
    want = j_pa.paged_decode_attention(*(jnp.asarray(x) for x in
                                         (q, kp, vp, lens, pt)))
    got = t_pa.paged_decode_attention(*(torch.from_numpy(x) for x in
                                        (q, kp, vp, lens, pt)))
    assert got.dtype == torch.float32 and got.shape == (3, nh, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_paged_decode_bf16_prescales_in_q_dtype():
    """bf16: q * scale is rounded in bf16 before the f32 math, in both
    packages, and the output comes back in bf16."""
    q, kp, vp, lens, pt = _paged_case(2, 4, 2, 64, 16, 4, (23, 64))
    qb = torch.from_numpy(q).bfloat16()
    kb = torch.from_numpy(kp).bfloat16()
    vb = torch.from_numpy(vp).bfloat16()
    got = t_pa.paged_decode_attention(qb, kb, vb, torch.from_numpy(lens),
                                      torch.from_numpy(pt))
    assert got.dtype == torch.bfloat16
    want = j_pa.paged_decode_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb)),
        jnp.asarray(lens), jnp.asarray(pt))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-5)
    # the f32 plain version on the bf16-rounded pre-scaled q
    scale = 1.0 / math.sqrt(64)
    f32 = t_pa._dense_fallback((qb * scale).float(), kb.float(), vb.float(),
                               torch.from_numpy(lens), torch.from_numpy(pt))
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(),
                               rtol=2 ** -7, atol=1e-5)


def test_decode_attention_unpadded_cache_matches_jax():
    """S = 37 is no page multiple: decode_attention pads, as the
    reference does."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 1, 4, 64).astype(np.float32)
    ck = rng.randn(2, 37, 2, 64).astype(np.float32)
    cv = rng.randn(2, 37, 2, 64).astype(np.float32)
    lens = np.array([37, 5], np.int32)
    want = j_pa.decode_attention(*(jnp.asarray(x) for x in (q, ck, cv, lens)))
    got = t_pa.decode_attention(*(torch.from_numpy(x) for x in
                                  (q, ck, cv, lens)))
    assert got.shape == (2, 1, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_paginate_cache_returns_views():
    rng = np.random.RandomState(2)
    ck = torch.from_numpy(rng.randn(3, 32, 2, 64).astype(np.float32))
    cv = torch.from_numpy(rng.randn(3, 32, 2, 64).astype(np.float32))
    kp, vp, pidx = t_pa.paginate_cache(ck, cv)
    jkp, jvp, jidx = j_pa.paginate_cache(jnp.asarray(ck.numpy()),
                                         jnp.asarray(cv.numpy()))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jvp))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    assert kp.data_ptr() == ck.data_ptr() and vp.data_ptr() == cv.data_ptr()
    ck[1, 20, 1] = 7.0                   # a write to the cache shows in
    assert bool((kp[1, 3, 4] == 7.0).all())   # its page view
    with pytest.raises(ValueError, match="page multiple"):
        t_pa.paginate_cache(ck[:, :30], cv[:, :30])


def test_paginate_cache_layer_stack_gives_each_layers_views():
    """A [L, B, S, kvh, d] cache: views [L, kvh, P, page, d] whose layer
    l is the layer-l cache's paging, sharing its storage."""
    rng = np.random.RandomState(3)
    ck = torch.from_numpy(rng.randn(2, 3, 32, 2, 64).astype(np.float32))
    cv = torch.from_numpy(rng.randn(2, 3, 32, 2, 64).astype(np.float32))
    kp, vp, pidx = t_pa.paginate_cache(ck, cv)
    assert kp.shape == (2, 2, 6, 16, 64) and pidx.shape == (3, 2)
    assert kp.data_ptr() == ck.data_ptr() and vp.data_ptr() == cv.data_ptr()
    for li in range(2):
        jkp, jvp, jidx = j_pa.paginate_cache(jnp.asarray(ck[li].numpy()),
                                             jnp.asarray(cv[li].numpy()))
        np.testing.assert_array_equal(kp[li].numpy(), np.asarray(jkp))
        np.testing.assert_array_equal(vp[li].numpy(), np.asarray(jvp))
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    ck[1, 2, 17, 0] = 5.0
    assert bool((kp[1, 0, 5, 1] == 5.0).all())


def test_use_kernel_raises_without_a_card_or_a_kernel():
    q, kp, vp, lens, pt = (torch.from_numpy(x) for x in
                           _paged_case(2, 4, 2, 64, 16, 4, (5, 9)))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        t_pa.paged_decode_attention(q, kp, vp, lens, pt, use_kernel=True)
    with pytest.raises(ValueError, match="does not take"):
        t_pa.paged_decode_attention(q[..., :32], kp[..., :32], vp[..., :32],
                                    lens, pt, use_kernel=True)
    assert not t_pa.supported((2, 6, 64), (4, 9, 16, 64))     # 6 % 4
    assert t_pa.supported((2, 8, 128), (2, 9, 32, 128), torch.float32)


# ---------------- the model's cache paths -----------------------------------

def test_forward_with_cache_prefill_then_decode_matches_jax(mha):
    jm, tm = mha
    cfg = tm.cfg
    L, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    ids = np.random.default_rng(4).integers(0, 1024, (2, 7)).astype(np.int32)
    S = 20                                   # no page multiple
    zeros = np.zeros((L, 2, S, kvh, d), np.float32)
    jstate = _jstate(jm)
    lg_j, ck_j, cv_j = JL._forward_with_cache(
        jstate, jm.cfg, jnp.asarray(ids), jnp.asarray(zeros),
        jnp.asarray(zeros), jnp.zeros((2,), jnp.int32))
    tstate = dict(tm.state_dict())
    ck_t, cv_t = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    lg_t, ck2, _ = TL._forward_with_cache(
        tstate, cfg, torch.from_numpy(ids), ck_t, cv_t,
        torch.zeros((2,), dtype=torch.int32))
    assert ck2 is ck_t                       # written in place
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), rtol=0,
                               atol=1e-5)
    tok = np.argmax(np.asarray(lg_j)[:, -1], -1).astype(np.int32)[:, None]
    cur = np.full((2,), 7, np.int32)
    lg_j, ck_j, cv_j = JL._forward_with_cache(
        jstate, jm.cfg, jnp.asarray(tok), ck_j, cv_j, jnp.asarray(cur))
    lg_t, _, _ = TL._forward_with_cache(tstate, cfg, torch.from_numpy(tok),
                                        ck_t, cv_t, torch.from_numpy(cur))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), rtol=0,
                               atol=1e-5)


def test_forward_with_cache_decode_over_page_views_matches_jax(gqa,
                                                             monkeypatch):
    """S = 32, a page multiple: the decode step reads every layer through
    page views built once for the step (generate's route), with the two
    sequences at different lengths; logits and caches as the
    reference's."""
    jm, tm = gqa
    cfg = tm.cfg
    L, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    rng = np.random.RandomState(8)
    S = 32
    ck = (0.5 * rng.randn(L, 2, S, kvh, d)).astype(np.float32)
    cv = (0.5 * rng.randn(L, 2, S, kvh, d)).astype(np.float32)
    tok = rng.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([16, 9], np.int32)        # one opens the second page
    lg_j, ck_j, cv_j = JL._forward_with_cache(
        _jstate(jm), jm.cfg, *(jnp.asarray(x) for x in (tok, ck, cv, cur)))
    ck_t, cv_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    # not the per-layer padding route
    monkeypatch.setattr(t_pa, "decode_attention",
                        lambda *a, **k: pytest.fail("decode_attention ran"))
    lg_t, _, _ = TL._forward_with_cache(
        dict(tm.state_dict()), cfg, torch.from_numpy(tok), ck_t, cv_t,
        torch.from_numpy(cur))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), rtol=0,
                               atol=1e-5)


def test_decode_step_paged_matches_jax(gqa):
    """Three slots: mid-page, at a page boundary (the token opens the
    second page) and inactive (writes the scratch page)."""
    jm, tm = gqa
    cfg = tm.cfg
    L, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    rng = np.random.RandomState(6)
    page, n_pages = 16, 8
    kp = (0.5 * rng.randn(L, kvh, n_pages, page, d)).astype(np.float32)
    vp = (0.5 * rng.randn(L, kvh, n_pages, page, d)).astype(np.float32)
    pt = np.array([[3, 0, 0], [1, 5, 0], [0, 0, 0]], np.int32)
    lens = np.array([5, 16, 9], np.int32)
    active = np.array([True, True, False])
    toks = rng.randint(1, cfg.vocab_size, 3).astype(np.int32)
    lg_j, kp_j, vp_j = JL._decode_step_paged(
        _jstate(jm), jm.cfg, *(jnp.asarray(x) for x in
                               (toks, kp, vp, pt, lens, active)))
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lg_t, kp2, _ = TL._decode_step_paged(
        dict(tm.state_dict()), cfg, torch.from_numpy(toks), kp_t, vp_t,
        *(torch.from_numpy(x) for x in (pt, lens, active)))
    assert kp2 is kp_t
    np.testing.assert_allclose(lg_t.numpy()[active],
                               np.asarray(lg_j)[active], rtol=0, atol=1e-4)
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(vp_t.numpy(), np.asarray(vp_j), rtol=0,
                               atol=1e-5)


# ---------------- generate --------------------------------------------------

def _jgen(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


@pytest.mark.parametrize("model,fused,n", [
    ("mha", True, 8), ("mha", False, 7), ("gqa", True, 8)],
    ids=["mha_fused", "mha_unfused", "gqa_fused"])
def test_generate_token_identical_to_jax(request, flag, model, fused, n):
    jm, tm = request.getfixturevalue(model)
    ids = np.random.default_rng(0).integers(0, 1024, (2, 7)).astype(np.int32)
    flag(fused)
    got = tm.generate(ids, max_new_tokens=n)
    assert got.dtype == torch.int32 and got.shape == (2, n)
    np.testing.assert_array_equal(got.numpy(), _jgen(jm, ids,
                                                     max_new_tokens=n))


def test_generate_eos_and_max_length_match_jax(mha):
    """EOS at the second token pads the rest of that row with EOS; the
    max_length cap cuts max_new_tokens to max_length - prompt."""
    jm, tm = mha
    ids = np.random.default_rng(1).integers(0, 1024, (2, 5)).astype(np.int32)
    base = tm.generate(ids, max_new_tokens=6).numpy()
    eos = int(base[0, 1])
    kw = dict(max_new_tokens=20, max_length=11, eos_token_id=eos)
    got = tm.generate(ids, **kw).numpy()
    assert got.shape == (2, 6)
    assert (got[0, 1:] == eos).all()
    np.testing.assert_array_equal(got, _jgen(jm, ids, **kw))


def test_generate_one_token_matches_jax(mha):
    jm, tm = mha
    ids = np.random.default_rng(2).integers(0, 1024, (3, 4)).astype(np.int32)
    got = tm.generate(ids, max_new_tokens=1).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_array_equal(got, _jgen(jm, ids, max_new_tokens=1))


def test_generate_matches_no_cache_greedy(mha):
    """The cached path emits the tokens of the full-forward greedy loop
    (reference tests/test_inference.py:26-39)."""
    _, tm = mha
    ids = np.random.default_rng(0).integers(0, 1024, (2, 7)).astype(np.int32)
    out = tm.generate(ids, max_new_tokens=6).numpy()
    cur = torch.from_numpy(ids)
    with torch.no_grad():
        for step in range(6):
            nxt = torch.argmax(tm(cur)[:, -1], dim=-1).to(torch.int32)
            np.testing.assert_array_equal(out[:, step], nxt.numpy())
            cur = torch.cat([cur, nxt[:, None]], dim=1)


def test_sampling_seeded_and_top_k(mha):
    _, tm = mha
    ids = np.random.default_rng(2).integers(0, 1024, (2, 4)).astype(np.int32)

    def sample(**kw):
        return tm.generate(ids, max_new_tokens=10, do_sample=True,
                           **kw).numpy()

    a, b = sample(top_k=8, seed=7), sample(top_k=8, seed=7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, sample(top_k=8, seed=8))
    # top_k=1 leaves only the argmax
    np.testing.assert_array_equal(sample(top_k=1, seed=3),
                                  tm.generate(ids, max_new_tokens=10).numpy())
    # every draw lies in the top 3 of the logits at its position
    out = sample(top_k=3, seed=5)
    with torch.no_grad():
        logits = tm(torch.from_numpy(np.concatenate([ids, out], axis=1)))
    top3 = torch.topk(logits[:, ids.shape[1] - 1:-1], 3, dim=-1).indices
    assert bool((top3 == torch.from_numpy(out)[..., None]).any(-1).all())


# ---------------- the bucketed engine ----------------------------------------

def _drive(engine, req_cls, workload, max_ticks=400):
    reqs, trace = [], []
    todo = list(workload)
    tick = 0
    while (todo or engine.has_work) and tick < max_ticks:
        while todo and todo[0][0] <= tick:
            _, prompt, n, eos = todo.pop(0)
            r = req_cls(list(prompt), max_new_tokens=n, eos_token_id=eos)
            engine.add_request(r)
            reqs.append(r)
        engine.step()
        trace.append((len(engine.finished), engine.preemptions))
        tick += 1
    assert not engine.has_work
    return reqs, trace


def _expected(tm, prompt, n, eos):
    """The port's own generate, cut after the first EOS as the engine
    stops there."""
    out = tm.generate(np.array([prompt], np.int32), max_new_tokens=n,
                      eos_token_id=eos).numpy()[0].tolist()
    if eos is not None and eos in out:
        out = out[:out.index(eos) + 1]
    return out


def _scenario(name, tm):
    """(engine knobs, workload [(tick, prompt, max_new, eos)])."""
    if name == "group_mixed_reuse_eos":
        # one round admits three bucket-8 prompts (one k=4 prefill) and a
        # bucket-16 one; two more wait for slots, which an EOS frees early
        eos = _expected(tm, [4, 9, 2], 6, None)[1]
        return (dict(max_batch=4, max_seq=64, prefill_buckets=(8, 16)),
                [(0, [4, 9, 2], 6, eos), (0, [5, 3], 5, None),
                 (0, [8, 1, 7, 6], 4, None), (0, list(range(1, 13)), 3, None),
                 (0, [31, 2], 5, None), (2, [6, 6, 6], 4, None)])
    if name == "preempt":
        return (dict(max_batch=2, max_seq=64, prefill_buckets=(8,),
                     total_pages=5),
                [(0, [11, 5], 38, None), (0, [7, 19], 38, None)])
    if name == "capacity_cap":
        return (dict(max_batch=2, max_seq=64, prefill_buckets=(8,),
                     total_pages=4),
                [(0, [1, 2], 50, None)])
    return (dict(max_batch=2, max_seq=64, prefill_buckets=(8,)),
            [(0, [7, 21, 3], 5, None), (1, [9, 4], 6, None)])


@pytest.mark.parametrize("name,model", [
    ("group_mixed_reuse_eos", "mha"), ("preempt", "mha"),
    ("capacity_cap", "mha"), ("gqa", "gqa")])
def test_bucketed_engine_token_identical(request, name, model):
    jm, tm = request.getfixturevalue(model)
    knobs, workload = _scenario(name, tm)
    je = JEngine(jm, ragged=False, slo=False, speculative=False,
                 request_trace=False, **knobs)
    te = TEngine(tm, ragged=False, device="cpu", **knobs)
    assert te._pcache is None and te.buckets == je.buckets
    jreqs, jtrace = _drive(je, JReq, workload)
    treqs, ttrace = _drive(te, TReq, workload)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert ttrace == jtrace
    assert set(te.prefill_calls) == set(je._compiled_prefill)
    assert te.prefill_tokens_total == je.prefill_tokens_total
    assert te.pool.n_free == te.pool.n_pages - 1 and not any(te.slot_pages)
    for r, (_, prompt, n, eos) in zip(treqs, workload):
        if name == "capacity_cap":
            cap = (te.pool.n_pages - 1) * te.page
            assert 0 < len(r.prompt) + len(r.output) <= cap < len(prompt) + n
            n = len(r.output)
        assert r.output == _expected(tm, prompt, n, eos), r.prompt
    if name == "group_mixed_reuse_eos":
        assert te.prefill_calls[(8, 4)] == 1 and (16, 1) in te.prefill_calls
        assert len(treqs[0].output) == 2          # stopped at its EOS
    if name == "preempt":
        assert te.preemptions >= 1


def test_bucketed_sampling_is_seeded(mha):
    _, tm = mha

    def run(seed):
        eng = TEngine(tm, max_batch=2, max_seq=64, prefill_buckets=(8,),
                      ragged=False, greedy=False, seed=seed, device="cpu")
        reqs = [TReq([3, 1, 4], max_new_tokens=6), TReq([1, 5], 6)]
        eng.run(reqs)
        return [r.output for r in reqs]

    assert run(11) == run(11)
    assert run(11) != run(12)


def test_ragged_flag_selects_the_bucketed_engine(mha, monkeypatch):
    """ragged=False and FLAGS_ragged_attention=0 (set_flags or the
    environment) reach the engine, also through the gateway's
    build_engine."""
    _, tm = mha
    assert TEngine(tm, device="cpu")._ragged
    assert not t_gw.build_engine(tm, ragged=False, device="cpu")._ragged
    ptt.set_flags({"FLAGS_ragged_attention": False})
    try:
        eng = TEngine(tm, device="cpu")
    finally:
        ptt.set_flags({"FLAGS_ragged_attention": True})
    assert not eng._ragged and eng._pcache is None
    monkeypatch.setenv("FLAGS_ragged_attention", "0")
    assert not t_gw.build_engine(tm, device="cpu")._ragged


def test_gateway_streams_bucketed_engine(mha):
    """The HTTP gateway over a bucketed engine streams generate's
    tokens."""
    import json
    import urllib.request
    _, tm = mha
    eng = t_gw.build_engine(tm, max_batch=2, max_seq=64, ragged=False,
                            device="cpu")
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        prompt = [9, 4, 2, 8, 1, 77]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({"prompt": prompt, "max_new_tokens": 6,
                             "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            doc = json.loads(resp.read())
    finally:
        gateway.drain(timeout=30)
        gateway.stop()
    assert len(doc.pop("trace_id")) == 32      # tracing armed by default
    assert doc == {"status": "served",
                   "output": _expected(tm, prompt, 6, None)}
    assert eng.decode_steps >= 5 and eng.model_steps == 0
