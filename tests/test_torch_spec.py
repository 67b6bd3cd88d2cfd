"""Self-speculative decoding in the port's ragged engine against the JAX
package's, on the reference's tiny LLaMA (vocab 128, hidden 64, 2 layers,
4 heads) in fp32 on the CPU. The reference engine runs with
speculative=True, slo=False, request_trace=False; the port's default
engine arms speculation the same way. Every engine scenario holds the
port's tokens, per-tick packed rows and preemptions, and its drafted and
accepted counts identical to the reference's; the drafter overrides are
the reference tests' (tests/test_serving_spec.py): a perfect drafter that
proposes the model's own greedy continuation and a wrong one whose first
draft always disagrees."""
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.inference.serving import _ngram_propose as j_ngram
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.framework import core as t_core
from paddle_tpu_torch.inference import gateway as t_gw
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.inference.serving import _ngram_propose as t_ngram
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax

from _torch_threads import one_torch_thread  # noqa: F401,E402

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=256, dtype="float32")
VERIFY_ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(use_recompute=False, **TINY))
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TL.LlamaConfig(**TINY)
    tm = TL.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, cfg, "cpu"))
    return jm, tm


_GREEDY = {}


def _greedy(tm, prompt, n=192):
    """The model's greedy continuation of `prompt` (the port's
    `generate`, memoized)."""
    key = tuple(prompt)
    if len(_GREEDY.get(key, ())) < n:
        out = tm.generate(np.array([prompt], np.int32), max_new_tokens=n)
        _GREEDY[key] = [int(t) for t in out[0].tolist()]
    return _GREEDY[key][:n]


def _install(eng, tm, mode, k_force=None):
    """The reference tests' drafters, on either engine: "perfect"
    proposes the greedy continuation, "wrong" a first draft that always
    disagrees; both clamp as `_draft_for_slot` does."""
    def draft(i, budget):
        slot = eng.slots[i]
        req = slot.req
        ref = _greedy(tm, list(req.prompt))
        k = min(slot.spec_k if k_force is None else k_force, budget,
                req.max_new_tokens - slot.produced - 1,
                eng.S - 1 - slot.length)
        if k <= 0:
            return []
        if mode == "perfect":
            return list(ref[len(req.output):len(req.output) + k])
        return [(ref[len(req.output)] + 1) % eng.cfg.vocab_size] * k

    eng._draft_for_slot = draft
    return draft


def _drive(eng, req_cls, workload, cap=2000):
    """workload: [(tick, prompt, max_new, eos)]. Returns (requests, trace
    of (packed rows, finished, preemptions) per tick)."""
    reqs, trace, todo, tick = [], [], list(workload), 0
    while (todo or eng.has_work) and tick < cap:
        while todo and todo[0][0] <= tick:
            _, prompt, n, eos = todo.pop(0)
            r = req_cls(list(prompt), max_new_tokens=n, eos_token_id=eos)
            eng.add_request(r)
            reqs.append(r)
        eng.step()
        trace.append((eng.last_packed_tokens, len(eng.finished),
                      eng.preemptions))
        tick += 1
    assert not eng.has_work, "engine failed to drain"
    return reqs, trace


def _pair_run(models, knobs, workload, drafter=None, k_force=None,
              port_kw=None):
    """The same workload through the reference's speculative engine and
    the port's (default arming unless `port_kw` says otherwise), with
    the same drafter override; asserts tokens, statuses, per-tick trace,
    drafted and accepted counts identical and both pools free. Returns
    (reference engine, port engine, port requests, trace)."""
    jm, tm = models
    je = JEngine(jm, speculative=True, slo=False, request_trace=False,
                 **knobs)
    te = TEngine(tm, device="cpu", **knobs, **(port_kw or {}))
    if drafter:
        _install(je, tm, drafter, k_force)
        _install(te, tm, drafter, k_force)
    jreqs, jtrace = _drive(je, JReq, workload)
    treqs, ttrace = _drive(te, TReq, workload)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert ttrace == jtrace
    assert (te.spec_drafted, te.spec_accepted) == (je.spec_drafted,
                                                   je.spec_accepted)
    assert [(r.spec_drafted, r.spec_accepted) for r in treqs] == \
        [(r.spec_drafted, r.spec_accepted) for r in jreqs]
    assert te.pool.n_free == te.pool.n_pages - 1
    assert je.pool.n_free == je.pool.n_pages - 1
    return je, te, treqs, ttrace


def _copy_motif(seed, tail):
    """A 12-token motif twice, then a tail: the model's greedy decode
    quotes the context, which the n-gram drafter predicts."""
    rng = np.random.RandomState(seed)
    motif = rng.randint(1, 128, 12).tolist()
    return motif + motif + rng.randint(1, 128, tail).tolist()


# ------------------------------------------------------------- the drafter

@pytest.mark.parametrize("ctx,k,max_n,min_n,want", [
    ([7, 1, 2, 9, 1, 2, 3, 1, 2], 3, 3, 1, [3, 1, 2]),
    ([5, 1, 2, 3, 8, 2, 3], 2, 3, 1, [8, 2]),
    ([4, 9, 4, 9, 4, 9], 4, 3, 1, [4, 9]),
    ([1, 2, 3, 4], 4, 3, 1, []),
    ([1, 2], 0, 3, 1, []),
    ([1], 4, 3, 1, []),
    ([1, 2, 1], 8, 2, 1, [2, 1]),
    ([1, 9, 9, 9, 2, 5, 1], 2, 3, 2, []),
    ([1, 9, 9, 9, 2, 5, 1], 2, 3, 1, [9, 9]),
], ids=["most_recent", "longest_ngram", "periodic", "no_match", "k0",
        "short_ctx", "truncated", "min_ngram_floor", "min_ngram_1"])
def test_ngram_propose_matches_reference_cases(ctx, k, max_n, min_n, want):
    """The reference's TestDrafter cases: both copies give the same."""
    assert j_ngram(ctx, k, max_n, min_n) == want
    assert t_ngram(ctx, k, max_n, min_n) == want


@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_matches_reference_random(seed):
    """Seeded random contexts over small vocabularies (repeats and
    periodic tails), every k and n-gram bound."""
    rng = np.random.RandomState(seed)
    for _ in range(60):
        vocab = int(rng.randint(2, 12))
        ctx = rng.randint(0, vocab, int(rng.randint(0, 40))).tolist()
        if rng.rand() < 0.3 and ctx:
            p = int(rng.randint(1, 5))
            ctx = ctx + (ctx[-p:] * 4)
        k, lo = int(rng.randint(0, 9)), int(rng.randint(1, 4))
        hi = int(rng.randint(lo, 5))
        assert t_ngram(ctx, k, hi, lo) == j_ngram(ctx, k, hi, lo)


# ------------------------------------------------------- parity and arming

def test_copy_motif_parity_and_fewer_ticks_than_kill_switch(models):
    """The n-gram drafter on copy-motif prompts (mixed decode and
    chunked prefill): tokens, ticks and counts identical to the
    reference's speculative engine; fewer ticks than the port's kill
    switch, with the same tokens, which are greedy decoding's."""
    _, tm = models
    prompts = [_copy_motif(1, 5), _copy_motif(2, 3), _copy_motif(3, 9)]
    workload = [(0, prompts[0], 24, None), (0, prompts[1], 24, None),
                (2, prompts[2], 24, None)]
    knobs = dict(max_batch=2, max_seq=96, max_chunk_tokens=16)
    _, te, treqs, trace = _pair_run(models, knobs, workload)
    assert te._spec and te.max_draft_tokens == 4
    assert te.spec_accepted > 0
    off = TEngine(tm, device="cpu", speculative=False, **knobs)
    oreqs, otrace = _drive(off, TReq, workload)
    assert [r.output for r in treqs] == [r.output for r in oreqs]
    assert len(trace) < len(otrace)
    for p, r in zip(prompts, treqs):
        assert r.output == _greedy(tm, p, 24)


def test_mixed_tight_pool_parity(models):
    """The reference's on/off workload (decode + chunked prefill + a
    tight pool) with the n-gram drafter."""
    _, tm = models
    prompts = [[3, 5, 7], list(range(1, 20)), [9, 4], list(range(2, 30))]
    workload = [(0, p, 10, None) for p in prompts]
    knobs = dict(max_batch=2, max_seq=64, total_pages=6, max_chunk_tokens=8)
    _, _, treqs, _ = _pair_run(models, knobs, workload)
    for p, r in zip(prompts, treqs):
        assert r.output == _greedy(tm, p, 10)


def test_kill_switch_flag_matches_kwarg(models, monkeypatch):
    """FLAGS_speculative=0 is the engine built with speculative=False:
    same tokens and per-tick trace, nothing drafted; the default engine
    arms and gives the same tokens."""
    _, tm = models
    workload = [(0, [9, 4, 2], 8, None), (0, list(range(1, 20)), 8, None),
                (0, [3, 3, 5, 8], 8, None)]
    knobs = dict(max_batch=2, max_seq=64, total_pages=6, max_chunk_tokens=8)
    monkeypatch.setitem(t_core._flags, "FLAGS_speculative", False)
    flag_eng = TEngine(tm, device="cpu", **knobs)
    flag_reqs, flag_trace = _drive(flag_eng, TReq, workload)
    monkeypatch.setitem(t_core._flags, "FLAGS_speculative", True)
    kw_eng = TEngine(tm, device="cpu", speculative=False, **knobs)
    kw_reqs, kw_trace = _drive(kw_eng, TReq, workload)
    on_eng = TEngine(tm, device="cpu", **knobs)
    on_reqs, _ = _drive(on_eng, TReq, workload)
    assert not flag_eng._spec and not kw_eng._spec and on_eng._spec
    assert ([r.output for r in flag_reqs] == [r.output for r in kw_reqs]
            == [r.output for r in on_reqs])
    assert flag_trace == kw_trace
    assert flag_eng.spec_drafted == 0


def test_env_flag_sets_draft_length(models, monkeypatch):
    _, tm = models
    monkeypatch.setenv("FLAGS_speculative_draft_tokens", "2")
    assert TEngine(tm, device="cpu").max_draft_tokens == 2
    monkeypatch.setenv("FLAGS_speculative", "0")
    assert not TEngine(tm, device="cpu")._spec


def test_sampling_bucketed_and_zero_draft_engines_never_arm(models,
                                                            monkeypatch):
    _, tm = models
    for kw in (dict(greedy=False), dict(ragged=False),
               dict(max_draft_tokens=0)):
        assert not TEngine(tm, device="cpu", speculative=True, **kw)._spec
    assert TEngine(tm, device="cpu")._spec
    # the argument overrides the flag
    monkeypatch.setitem(t_core._flags, "FLAGS_speculative", False)
    assert TEngine(tm, device="cpu", speculative=True)._spec


def test_spec_step_launches_nothing_extra_without_drafts(models):
    """A drafter that proposes nothing leaves every tick's packed rows
    those of the kill switch (verify entries of one row)."""
    _, tm = models
    workload = [(0, [9, 4, 2], 6, None), (1, list(range(1, 25)), 6, None)]
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=8)
    on = TEngine(tm, device="cpu", **knobs)
    on._draft_for_slot = lambda i, b: []
    off = TEngine(tm, device="cpu", speculative=False, **knobs)
    on_reqs, on_trace = _drive(on, TReq, workload)
    off_reqs, off_trace = _drive(off, TReq, workload)
    assert on_trace == off_trace
    assert [r.output for r in on_reqs] == [r.output for r in off_reqs]


# ------------------------------------------------- verification, rollback

def test_perfect_drafter_multi_token_ticks(models):
    """Every draft verifies: ticks collapse about (k + 1)-fold."""
    _, tm = models
    prompt = [3, 5, 7]
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=16,
                 max_draft_tokens=4)
    _, te, treqs, trace = _pair_run(models, knobs, [(0, prompt, 25, None)],
                                    drafter="perfect")
    assert treqs[0].output == _greedy(tm, prompt, 25)
    assert len(trace) <= 8
    assert te.spec_accepted >= 15 and te.spec_drafted == te.spec_accepted


def test_rejection_mid_page_frees_pages_exactly(models):
    """Rejected draft rows whose page lies wholly past the truncated
    length give it back the same tick."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64,
                  max_chunk_tokens=16, max_draft_tokens=4)
    _install(eng, tm, "wrong", k_force=4)
    prompt = list(range(1, 14))
    req = TReq(prompt, max_new_tokens=8)
    eng.add_request(req)
    eng.step()                           # prefill + first token
    assert eng.slots[0].length == 13
    free_before = eng.pool.n_free
    eng.step()                           # decode + 4 rejected drafts
    assert eng.spec_drafted == 4 and eng.spec_accepted == 0
    assert eng.slots[0].length == 14
    assert eng.pool.n_free == free_before
    assert len(eng.slot_pages[0]) == 1
    assert list(eng.page_table[0, 1:]) == [0] * (eng.ppmax - 1)
    while eng.has_work:
        eng.step()
    assert req.output == _greedy(tm, prompt, 8)
    assert eng.pool.n_free == eng.pool.n_pages - 1
    # the same scenario through both engines
    _pair_run(models, dict(max_batch=1, max_seq=64, max_chunk_tokens=16,
                           max_draft_tokens=4),
              [(0, prompt, 8, None)], drafter="wrong", k_force=4)


def test_rollback_never_touches_prefix_shared_pages(models):
    """Rollback after rejected drafts never frees a page the request
    shares through the prefix cache."""
    jm, tm = models
    rng = np.random.RandomState(11)
    prefix = rng.randint(1, 128, 32).tolist()
    knobs = dict(max_batch=2, max_seq=96, max_chunk_tokens=32,
                 prefix_cache=True, max_draft_tokens=4)
    eng = TEngine(tm, device="cpu", **knobs)
    a = TReq(prefix + [5, 9], max_new_tokens=3)
    eng.add_request(a)
    while eng.has_work:
        eng.step()
    cached = set(eng._pcache.by_page)
    assert len(cached) == 2
    _install(eng, tm, "wrong", k_force=4)
    b = TReq(prefix + [7, 3], max_new_tokens=8)
    eng.add_request(b)
    eng.step()                           # admission attaches 2 cached pages
    i = next(i for i, s in enumerate(eng.slots) if s.req is b)
    assert set(eng.slot_pages[i][:2]) == cached
    hits = eng._pcache.hits
    while eng.has_work:
        eng.step()
    assert set(eng._pcache.by_page) >= cached
    assert eng.spec_drafted > 0 and eng.spec_accepted == 0
    assert b.output == _greedy(tm, b.prompt, 8)
    assert eng._pcache.hits == hits
    assert eng.pool.n_free == eng.pool.n_pages - 1
    # both engines, the shared prefix attached mid-run
    _pair_run(models, knobs, [(0, prefix + [5, 9], 3, None),
                              (6, prefix + [7, 3], 8, None)],
              drafter="wrong", k_force=4)


def test_draft_past_max_seq_is_clamped(models):
    """A drafter that proposes past the slot's KV ceiling is cut; the
    request finishes at capacity as the kill switch's does."""
    _, tm = models
    knobs = dict(max_batch=1, max_seq=32, max_chunk_tokens=16,
                 max_draft_tokens=4)
    outs = []
    for spec in (True, False):
        eng = TEngine(tm, device="cpu", speculative=spec, **knobs)
        if spec:
            real = _install(eng, tm, "perfect")
            eng._draft_for_slot = lambda i, b: real(i, b) + [1, 1, 1, 1]
        req = TReq([2, 4, 6], max_new_tokens=100)
        eng.add_request(req)
        while eng.has_work:
            eng.step()
        assert eng.pool.n_free == eng.pool.n_pages - 1
        outs.append(req.output)
    assert outs[0] == outs[1] and 3 + len(outs[0]) <= 32


def test_eos_inside_accepted_drafts(models):
    """EOS landing inside a verified run commits up to it, never past."""
    _, tm = models
    prompt = [9, 4]
    ref = _greedy(tm, prompt, 6)
    eos = ref[3]
    stop = ref.index(eos)
    _, _, treqs, _ = _pair_run(
        models, dict(max_batch=1, max_seq=64, max_chunk_tokens=16,
                     max_draft_tokens=4),
        [(0, prompt, 16, eos)], drafter="perfect")
    assert treqs[0].output == ref[:stop + 1]
    assert treqs[0].output[-1] == eos


def test_preemption_with_draft_rows_in_flight(models):
    """A pool of 5 pages preempts while slots carry draft rows; resume
    stays exact and nothing leaks."""
    _, tm = models
    knobs = dict(max_batch=2, max_seq=64, total_pages=5, max_chunk_tokens=8,
                 max_draft_tokens=4)
    workload = [(0, [11, 5], 38, None), (0, [7, 19], 38, None)]
    _, te, treqs, _ = _pair_run(models, knobs, workload, drafter="perfect")
    assert te.preemptions >= 1 and te.spec_accepted > 0
    for r in treqs:
        assert r.output == _greedy(tm, r.prompt, 38)


def test_adaptive_draft_length_shrinks_and_regrows(models):
    """k halves on rejected ticks (4 -> 2 -> 1) and doubles back after
    spec_hysteresis full-acceptance ticks."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=128,
                  max_chunk_tokens=16, max_draft_tokens=4, spec_hysteresis=2)
    ref = _greedy(tm, [3, 5, 7], 192)
    mode = {"wrong": True}

    def draft(i, budget):
        slot = eng.slots[i]
        req = slot.req
        k = min(slot.spec_k, budget, req.max_new_tokens - slot.produced - 1,
                eng.S - 1 - slot.length)
        if k <= 0:
            return []
        if mode["wrong"]:
            return [(ref[len(req.output)] + 1) % 128] * k
        return ref[len(req.output):len(req.output) + k]

    eng._draft_for_slot = draft
    req = TReq([3, 5, 7], max_new_tokens=120)
    eng.add_request(req)
    eng.step()                           # prefill tick, no drafting
    ks = []
    for _ in range(3):
        eng.step()
        ks.append(eng.slots[0].spec_k)
    assert ks == [2, 1, 1]
    mode["wrong"] = False
    regrown = []
    for _ in range(8):
        eng.step()
        regrown.append(eng.slots[0].spec_k)
    assert 2 in regrown and regrown[-1] == 4
    assert req.output == ref[:len(req.output)]


def test_health_snapshot_speculative_block(models):
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64,
                  max_chunk_tokens=16, max_draft_tokens=4)
    _install(eng, tm, "perfect")
    req = TReq([3, 5, 7], max_new_tokens=20)
    eng.add_request(req)
    while eng.has_work:
        eng.step()
    spec = eng.health_snapshot()["speculative"]
    assert spec["armed"] and spec["max_draft_tokens"] == 4
    assert spec["drafted"] == req.spec_drafted >= spec["accepted"] \
        == req.spec_accepted > 0
    assert spec["acceptance_rate"] == round(
        req.spec_accepted / req.spec_drafted, 4)
    off = TEngine(tm, device="cpu", speculative=False)
    assert off.health_snapshot()["speculative"] == {
        "armed": False, "max_draft_tokens": 4, "drafted": 0,
        "accepted": 0, "acceptance_rate": 0.0}


# ------------------------------------------------------------ the gateway

def test_gateway_one_frame_per_tick(models):
    """EngineRunner._dispatch sends every token a tick produced as ONE
    frame: with accepted drafts some frames carry several tokens."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64,
                  max_chunk_tokens=16, max_draft_tokens=4)
    _install(eng, tm, "perfect")
    runner = t_gw.EngineRunner(eng)      # never started: manual ticks
    req = TReq([3, 5, 7], max_new_tokens=20)
    stream = runner.submit(req)
    n = 0
    with runner.lock:
        runner._apply_inbox()
    while eng.has_work and n < 100:
        with runner.lock:
            eng.step()
            runner._dispatch()
        n += 1
    events = []
    while not stream.q.empty():
        events.append(stream.q.get())
    frames = [e[1] for e in events if e[0] == "tokens"]
    assert len(frames) <= n
    assert any(len(f) > 1 for f in frames)
    assert [t for f in frames for t in f] == req.output == \
        _greedy(tm, [3, 5, 7], 20)
    assert events[-1][0] == "end" and events[-1][1] == "served"


def test_gateway_healthz_carries_speculative(models):
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=2, max_seq=64)
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["engine"]["speculative"]["armed"] is True
        assert health["engine"]["speculative"]["max_draft_tokens"] == 4
    finally:
        gateway.stop()


# ------------------------------------------------------- the serving step

def test_ragged_step_verify_rows_matches_reference(models):
    """`_ragged_step_paged(verify_rows=K)` against the reference's at
    fp32: [B, K, V] right-aligned logits of a verify entry (q_len 5), a
    decode row, a prefill chunk and an idle slot; the last slot equals
    the last-row branch's logits, and row_tiles changes nothing on the
    CPU."""
    jm, tm = models
    cfg = tm.cfg
    page, B, ppmax, K = 16, 4, 4, 5
    L_, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    n_pages = B * ppmax + 1
    rng = np.random.RandomState(5)
    kp = (0.5 * rng.randn(L_, kvh, n_pages, page, d)).astype(np.float32)
    vp = (0.5 * rng.randn(L_, kvh, n_pages, page, d)).astype(np.float32)
    # (q_start, q_len, kv_len): verify 5 rows at 40 keys, decode at 17,
    # a 7-row chunk at 30, idle
    meta = [(0, 5, 40), (5, 1, 17), (6, 7, 30), (0, 0, 0)]
    T = 16
    pt = np.zeros((B, ppmax), np.int32)
    perm = rng.permutation(n_pages - 1) + 1
    nxt = 0
    for s, (_, _, kl) in enumerate(meta):
        n = -(-kl // page)
        pt[s, :n] = perm[nxt:nxt + n]
        nxt += n
    toks = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    pids = np.zeros(T, np.int32)
    offs = np.zeros(T, np.int32)
    for s, (qs, ql, kl) in enumerate(meta):
        for t in range(ql):
            p = kl - ql + t
            toks[qs + t] = rng.randint(1, 128)
            pos[qs + t], pids[qs + t], offs[qs + t] = (p, pt[s, p // page],
                                                       p % page)
    qs_, ql_, kl_ = (np.array([m[i] for m in meta], np.int32)
                     for i in range(3))
    jstate = {k: v.data for k, v in jm.state_dict().items()}
    want, _, _ = JL._ragged_step_paged(
        jstate, jm.cfg, *(jnp.asarray(x) for x in (
            toks, pos, kp, vp, pids, offs, pt, qs_, ql_, kl_)),
        verify_rows=K)
    want = np.asarray(want)
    st = {k: v.detach() for k, v in tm.state_dict().items()}
    t = torch.from_numpy
    args = (t(toks), t(pos), t(kp.copy()), t(vp.copy()), t(pids), t(offs),
            t(pt), t(qs_), t(ql_), t(kl_))
    got, _, _ = TL._ragged_step_paged(st, cfg, *args, verify_rows=K,
                                      row_tiles=t(np.array([1, 1, 0, 0],
                                                           np.int32)))
    assert got.shape == (B, K, cfg.vocab_size) and got.dtype == torch.float32
    live = [(0, range(K)), (1, [K - 1]), (2, range(K))]
    for b, slots in live:
        for j in slots:
            np.testing.assert_allclose(got[b, j].numpy(), want[b, j],
                                       rtol=0, atol=VERIFY_ATOL)
    args = (t(toks), t(pos), t(kp.copy()), t(vp.copy()), t(pids), t(offs),
            t(pt), t(qs_), t(ql_), t(kl_))
    last, _, _ = TL._ragged_step_paged(st, cfg, *args)
    assert torch.equal(got[:3, -1], last[:3])
