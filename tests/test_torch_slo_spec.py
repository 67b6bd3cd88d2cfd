"""The SLO layer under self-speculative decoding, in the port against the
JAX package: the scenarios of tests/test_serving_spec.py that need the
layer or the modules it brings (the consumed-row exemption, a deadline
passing between draft and verify ticks, the serving.draft and
serving.verify_rollback fault points, the serving.spec_* series), and
priority against cache heat. The reference's tiny LLaMA in fp32 on the
CPU; the drafter overrides are tests/test_torch_spec.py's (perfect and
wrong); helpers from tests/test_torch_slo.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import observability as j_obs
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.utils import fault_injection as j_fi
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.framework import core as t_core
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.utils import fault_injection as t_fi
from tests.test_torch_slo import (assert_same, clean_registries,  # noqa: F401
                                  drive, expire_after, models, pair, req)
from tests.test_torch_spec import _greedy, _install

from _torch_threads import one_torch_thread  # noqa: F401,E402

SPEC = dict(speculative=True, max_draft_tokens=4)


def arm(spec):
    j_fi.configure(spec)
    t_fi.configure(spec)


def run_spec_pair(models, knobs, workload, drafter=None, k_force=None,
                  **kw):
    """The workload through both SLO-armed speculative engines with the
    same drafter override; everything `assert_same` holds, plus drafted
    and accepted counts."""
    _, tm = models
    je, te = pair(models, **knobs)
    assert je._spec and te._spec
    if drafter:
        _install(je, tm, drafter, k_force)
        _install(te, tm, drafter, k_force)
    jreqs, jtrace = drive(je, JReq, workload, **kw)
    treqs, ttrace = drive(te, TReq, workload, **kw)
    assert_same((je, jreqs, jtrace), (te, treqs, ttrace))
    assert (te.spec_drafted, te.spec_accepted) == (je.spec_drafted,
                                                   je.spec_accepted)
    assert [(r.spec_drafted, r.spec_accepted) for r in treqs] == \
        [(r.spec_drafted, r.spec_accepted) for r in jreqs]
    return je, te, treqs, ttrace


# ------------------------------------------------ consumed-row exemption

def test_midprompt_poison_not_quarantined_under_spec(models):
    """A non-finite logit in a row the host never consumes (window row 0
    of a prefill chunk longer than the window) does not quarantine under
    speculation, in either engine: the kill switch cannot change which
    requests fail."""
    _, tm = models
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=16, **SPEC)
    je, te = pair(models, **knobs)
    for eng in (je, te):
        eng._draft_for_slot = lambda i, b: []     # decode rows stay q_len 1
    jreal, treal = je._ragged_step, te._ragged_step

    def jpoisoned(st, cfg, toks, pos, kp, vp, page_ids, offs, page_table,
                  q_start, q_len, kv_len, verify_rows=None):
        lg, kp, vp = jreal(st, cfg, toks, pos, kp, vp, page_ids, offs,
                           page_table, q_start, q_len, kv_len,
                           verify_rows=verify_rows)
        bad = ((jnp.arange(lg.shape[0]) == 0)[:, None]
               & (jnp.arange(lg.shape[1]) == 0)[None, :] & (q_len[0] > 1))
        return jnp.where(bad[:, :, None], jnp.inf, lg), kp, vp

    def tpoisoned(*a, **kw):
        lg, kp, vp = treal(*a, **kw)
        q_len = a[10]
        if int(q_len[0]) > 1:
            lg = lg.clone()
            lg[0, 0] = float("inf")
        return lg, kp, vp

    je._ragged_step, te._ragged_step = jpoisoned, tpoisoned
    prompt = list(range(1, 41))          # 40 tokens: 3 chunks
    workload = [(0, req(prompt, 3))]
    jreqs, jtrace = drive(je, JReq, workload)
    treqs, ttrace = drive(te, TReq, workload)
    assert_same((je, jreqs, jtrace), (te, treqs, ttrace))
    assert treqs[0].status == "served" and te.quarantines == 0
    assert treqs[0].output == _greedy(tm, prompt, 3)


@pytest.mark.parametrize("where", ["verify_last", "verify_first",
                                   "outside_window", "kill_switch"])
def test_nonfinite_exemption_under_speculation(models, where):
    """The consumed-row window under speculation: a poisoned row of a
    verify entry (its first or its last) quarantines exactly its
    request, as the kill switch's poisoned producing row does; a
    poisoned window slot outside a decode row's window quarantines no
    one. Port and reference agree in each case (the reference's ok flag
    flipped where the port's logits go NaN)."""
    _, tm = models
    spec = where != "kill_switch"
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=16,
                 speculative=spec, max_draft_tokens=4)
    workload = [(0, req([3, 5, 7], 10)), (0, req([9, 2, 4], 10))]
    je, te = pair(models, **knobs)
    if spec:
        _install(je, tm, "perfect")
        _install(te, tm, "perfect")
    K = 5
    state = {"armed": False, "calls": 0}
    treal = te._ragged_step

    def tpoisoned(*a, **kw):
        lg, kp, vp = treal(*a, **kw)
        n = int(a[10][1])                # slot 1's q_len
        state["calls"] += 1
        # slot 1 once it decodes: a verify entry (q_len > 1) under
        # speculation, a decode row without; outside the window needs an
        # entry shorter than the window
        due = state["calls"] > 1 and n >= (2 if spec else 1)
        if where == "outside_window":
            due = due and n < K
        if not state["armed"] and due:
            state.update(armed=True, tick=state["calls"])
            lg = lg.clone()
            if where == "verify_last":
                lg[1, K - 1] = float("nan")
            elif where == "verify_first":
                lg[1, K - n] = float("nan")
            elif where == "outside_window":
                lg[1, 0] = float("nan")
            else:
                lg[1] = float("nan")
        return lg, kp, vp

    te._ragged_step = tpoisoned
    treqs, ttrace = drive(te, TReq, workload)
    assert state["armed"]
    quarantined = where != "outside_window"
    assert te.quarantines == int(quarantined)
    if quarantined:
        assert treqs[1].status == "failed"
        assert treqs[1].error == "non-finite logits"
        # the reference, its ok flag flipped on the same step
        jreal = je._ragged_fn()
        n = {"calls": 0}

        def jpoisoned(*args):
            nxt, ok, kp, vp = jreal(*args)
            n["calls"] += 1
            if n["calls"] == state["tick"]:
                ok = np.asarray(ok).copy()
                ok[1] = False
            return nxt, ok, kp, vp

        je._compiled_ragged = jpoisoned
    jreqs, jtrace = drive(je, JReq, workload)
    assert_same((je, jreqs, jtrace), (te, treqs, ttrace))
    assert treqs[0].status == "served"
    assert treqs[0].output == _greedy(tm, [3, 5, 7], 10)


# --------------------------------------------------------- deadlines

def test_deadline_expiry_between_draft_and_verify_ticks(models):
    """A deadline passing while drafts are in flight fails the request
    fast and reclaims every page, those funded for drafts included."""
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=16, **SPEC)
    workload = [(0, req([3, 5, 7], 500, deadline_s=600.0))]
    _, te, treqs, _ = run_spec_pair(models, knobs, workload, "perfect",
                                    on_tick=expire_after(5, 0))
    assert treqs[0].status == "deadline_missed"
    assert 0 < len(treqs[0].output) < 500
    assert te.spec_accepted > 0
    assert te.pool.n_free == te.pool.n_pages - 1
    assert all(s.free for s in te.slots)


def test_speculative_slo_kill_switch_trace_identical(models):
    """Speculation armed: FLAGS_serving_slo=0 and the armed layer with
    inert defaults give the same tokens, ticks, packed rows and drafts.
    (A pool held above the high water is not inert: degradation changes
    the packing, by design.)"""
    _, tm = models
    # a pool the load never holds above the high water: the layer inert
    knobs = dict(max_batch=2, max_seq=96, max_chunk_tokens=16, **SPEC)
    rng = np.random.RandomState(13)
    motif = rng.randint(1, 128, 12).tolist()
    workload = [(0, req(motif * 2 + [7], 16)),
                (1, req(rng.randint(1, 128, 30), 8)),
                (2, req(motif + [9, 9], 12))]
    _, te, treqs, ttrace = run_spec_pair(models, knobs, workload)
    t_core.set_flags({"FLAGS_serving_slo": False})
    try:
        off = TEngine(tm, device="cpu", **knobs)
    finally:
        t_core.set_flags({"FLAGS_serving_slo": True})
    oreqs, otrace = drive(off, TReq, workload)
    assert [r.output for r in oreqs] == [r.output for r in treqs]
    assert [t[:3] for t in otrace] == [t[:3] for t in ttrace]
    assert (off.spec_drafted, off.spec_accepted) == (te.spec_drafted,
                                                     te.spec_accepted)


# ------------------------------------------------------- fault points

def test_draft_fault_isolated_to_one_request(models):
    """serving.draft raising inside the tick quarantines one request
    through the isolation boundary; the engine survives."""
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=16,
                 speculative=True)
    workload = [(0, req([3 + i, 5], 6)) for i in range(3)]
    arm("serving.draft:raise@2")
    _, te, treqs, _ = run_spec_pair(models, knobs, workload)
    assert t_fi.stats()["points"]["serving.draft"]["triggered"] == 1
    assert sorted(r.status for r in treqs) == ["failed", "served", "served"]
    assert te.pool.n_free == te.pool.n_pages - 1


def test_verify_rollback_fault_isolated(models):
    """serving.verify_rollback raising mid-rollback fails one request;
    the pool accounting stays whole at drain."""
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=16, **SPEC)
    workload = [(0, req(list(range(1, 16)), 6)), (0, req([9, 4], 6))]
    arm("serving.verify_rollback:raise@1")
    _, te, treqs, _ = run_spec_pair(models, knobs, workload, "wrong",
                                    k_force=4)
    assert "failed" in [r.status for r in treqs]
    assert te.quarantines >= 1
    assert te.pool.n_free == te.pool.n_pages - 1


# ---------------------------------------------------------- telemetry

def test_counters_gauge_and_per_request_rates(models):
    """serving.spec_* in both registries: drafted and accepted counters
    and the acceptance-rate gauge equal each other, the per-request
    counts and the health block."""
    for obs in (j_obs, t_obs):
        obs.enable(True)
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=16, **SPEC)
    workload = [(0, req([3, 5, 7], 20))]
    je, te = pair(models, **knobs)
    _, tm = models
    _install(je, tm, "perfect")
    _install(te, tm, "perfect")
    drive(je, JReq, workload)
    jsnap = j_metrics.snapshot()
    treqs, _ = drive(te, TReq, workload)
    tsnap = t_metrics.snapshot()
    names = ("serving.spec_drafted_total", "serving.spec_accepted_total")
    for name in names:
        assert tsnap["counters"][name] == jsnap["counters"][name]
    drafted = tsnap["counters"][names[0]][""]
    accepted = tsnap["counters"][names[1]][""]
    assert drafted >= accepted > 0
    rate = tsnap["gauges"]["serving.spec_acceptance_rate"][""]
    assert rate == jsnap["gauges"]["serving.spec_acceptance_rate"][""]
    assert 0.0 < rate <= 1.0
    assert (treqs[0].spec_drafted, treqs[0].spec_accepted) == (drafted,
                                                               accepted)
    h = te.health_snapshot()["speculative"]
    assert h["armed"] and h["drafted"] == drafted
    assert h["acceptance_rate"] == round(accepted / drafted, 4)


def test_disarmed_spec_metrics_silent(models):
    """speculative=False: no spec series, in either package, even with
    the registry armed."""
    for obs in (j_obs, t_obs):
        obs.enable(True)
    je, te = pair(models, max_batch=1, max_seq=64, speculative=False)
    for eng, cls, m in ((je, JReq, j_metrics), (te, TReq, t_metrics)):
        eng.add_request(cls([4, 9], max_new_tokens=3))
        while eng.has_work:
            eng.step()
        snap = m.snapshot()
        assert not snap["counters"].get("serving.spec_drafted_total")
        assert eng.spec_drafted == 0
        assert eng.health_snapshot()["speculative"]["armed"] is False
        assert snap["counters"]["serving.prefix_misses_total"][""] == 1


# ----------------------------------------------- priority against heat

def test_priority_outranks_cache_heat(models):
    """SLO order is never subverted: a cold high-priority waiter still
    beats a hot low-priority one, in both engines."""
    rng = np.random.RandomState(37)
    prefix = [int(t) for t in rng.randint(1, 128, 32)]
    knobs = dict(max_batch=1, max_seq=96, max_chunk_tokens=48,
                 prefix_cache=True)
    workload = [(0, req(prefix + [5, 9], 2)), (3, req([7, 7], 6)),
                (4, req(prefix + [3], 2, priority=0)),
                (4, req([4, 8, 15], 2, priority=2))]
    je, te, treqs, _ = run_spec_pair(models, knobs, workload)
    order = [r.request_id for r in te.finished[-2:]]
    assert order == [3, 2]
    assert te._pcache.hits == je._pcache.hits >= 1
    assert torch.is_tensor(te.k_pool)
