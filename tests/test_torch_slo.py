"""The SLO layer of the port's serving engine against the JAX package's:
scheduling, admission control, shedding, degradation and the kill
switch, the scenarios of tests/test_serving_slo.py on the reference's
tiny LLaMA (vocab 128, hidden 64, 2 layers, 4 heads) in fp32 on the CPU.

The reference engine runs with slo=True, request_trace=False; the port's
default engine arms the layer (FLAGS_serving_slo defaults on), both with
speculation armed as their defaults are. Every scenario holds outputs,
statuses, terminal errors, the finish order, the counters (deadline
misses, sheds, quarantines, preemptions) and the per-tick trace (packed
rows, finished, preemptions, the effective chunk budget, the SLO
counters) identical. Nothing compared reads the wall clock: deadlines
are already past (1e-9), never expire, or are moved past between two
ticks on both engines alike. The shared helpers here serve
tests/test_torch_slo_faults.py and tests/test_torch_slo_spec.py too."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import observability as j_obs
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.inference.serving import QueueFull as JQueueFull
from paddle_tpu.models import llama as JL
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.utils import fault_injection as j_fi
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.framework import core as t_core
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.inference.serving import QueueFull as TQueueFull
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.utils import fault_injection as t_fi

from _torch_threads import one_torch_thread  # noqa: F401,E402

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=256, dtype="float32")

# health_snapshot fields that read the wall clock or name the device
WALL_CLOCK = ("tokens_per_s_ema", "retry_after_s", "device")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(use_recompute=False, **TINY))
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TL.LlamaConfig(**TINY)
    tm = TL.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, cfg, "cpu"))
    return jm, tm


@pytest.fixture(autouse=True)
def clean_registries():
    """Each package's fault schedule and metrics registry are process-
    wide: start and leave both disarmed and zeroed."""
    for fi in (j_fi, t_fi):
        fi.configure(None)
    for m in (j_metrics, t_metrics):
        m.reset()
    yield
    for fi in (j_fi, t_fi):
        fi.configure(None)
    for obs in (j_obs, t_obs):
        obs.enable(False)
    for m in (j_metrics, t_metrics):
        m.reset()


def pair(models, **knobs):
    """The reference's SLO-armed engine and the port's default engine on
    the same weights and knobs."""
    jm, tm = models
    je = JEngine(jm, slo=True, request_trace=False, **knobs)
    te = TEngine(tm, device="cpu", **knobs)
    assert je._slo and te._slo
    return je, te


def tick_state(eng):
    return (eng.last_packed_tokens, len(eng.finished), eng.preemptions,
            eng._eff_chunk, eng.quarantines, eng.deadline_misses,
            eng.sheds)


def drive(eng, req_cls, workload, cap=2000, on_tick=None, submit=None):
    """workload: [(tick, request kwargs)]; each request is submitted
    before the step of its tick. on_tick(eng, tick, reqs) runs after each
    step; submit(eng, req) replaces add_request. Returns (requests, trace
    of `tick_state` per tick)."""
    reqs, trace, todo, tick = [], [], list(workload), 0
    while (todo or eng.has_work) and tick < cap:
        while todo and todo[0][0] <= tick:
            _, kw = todo.pop(0)
            r = req_cls(**kw)
            (submit or type(eng).add_request)(eng, r)
            reqs.append(r)
        eng.step()
        tick += 1
        trace.append(tick_state(eng))
        if on_tick is not None:
            on_tick(eng, tick, reqs)
    assert not eng.has_work, "engine failed to drain"
    return reqs, trace


def req(prompt, n, **kw):
    return dict(prompt=list(prompt), max_new_tokens=n, **kw)


def counters(eng):
    return (eng.deadline_misses, eng.sheds, eng.quarantines,
            eng.preemptions)


def health(eng):
    """health_snapshot without the wall-clock fields."""
    snap = eng.health_snapshot()
    for k in WALL_CLOCK:
        snap.pop(k, None)
    if "prefix_cache" in snap:
        snap["prefix_cache"].pop("heat_ts")
    return snap


def assert_same(j, t):
    """(engine, requests, trace) of both packages: identical."""
    (je, jreqs, jtrace), (te, treqs, ttrace) = j, t
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert [r.error for r in treqs] == [r.error for r in jreqs]
    assert [r.request_id for r in te.finished] == \
        [r.request_id for r in je.finished]
    assert counters(te) == counters(je)
    assert ttrace == jtrace
    assert health(te) == health(je)
    assert te.pool.n_free == je.pool.n_free


def run_pair(models, knobs, workload, **kw):
    je, te = pair(models, **knobs)
    jreqs, jtrace = drive(je, JReq, workload, **kw)
    treqs, ttrace = drive(te, TReq, workload, **kw)
    assert_same((je, jreqs, jtrace), (te, treqs, ttrace))
    return je, te, treqs, ttrace


def expire_after(tick_no, which):
    """on_tick hook: after tick `tick_no`, move the deadline of request
    `which` into the past (the clock passing it between two ticks)."""
    def hook(eng, tick, reqs):
        if tick == tick_no:
            reqs[which].deadline_s = -1.0
    return hook


# ------------------------------------------------------------ scheduling

def test_priority_jumps_the_queue(models):
    """One slot: a priority-5 request submitted last is admitted first;
    equal priorities keep FIFO order."""
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8)
    workload = [(0, req([3, 5], 3)), (0, req([7, 9], 3)),
                (0, req([11, 2], 3, priority=5))]
    _, te, treqs, _ = run_pair(models, knobs, workload)
    assert [r.request_id for r in te.finished] == [2, 0, 1]
    assert all(r.status == "served" for r in treqs)


def test_edf_within_a_priority_class(models):
    """Same priority: the earlier deadline first, no deadline last."""
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8)
    workload = [(0, req([3, 5], 2, deadline_s=60.0)), (0, req([4, 6], 2)),
                (0, req([7, 9], 2, deadline_s=20.0))]
    _, te, _, _ = run_pair(models, knobs, workload)
    assert [r.request_id for r in te.finished] == [2, 0, 1]


def test_deadline_expired_waiter_fails_fast(models):
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8)
    workload = [(0, req([3, 5], 6)), (0, req([7, 9], 6, deadline_s=1e-9))]
    _, te, treqs, _ = run_pair(models, knobs, workload)
    running, dead = treqs
    assert dead.status == "deadline_missed" and dead.output == []
    assert "DeadlineExceeded" in dead.error
    assert running.status == "served"
    assert te.deadline_misses == 1
    assert te.pool.n_free == te.pool.n_pages - 1


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "bucketed"])
def test_deadline_expired_inflight_releases_pages(models, ragged):
    """An admitted request whose deadline passes between two ticks
    mid-generation fails fast; its slot and pages come back."""
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=8, ragged=ragged)
    workload = [(0, req([3, 5, 7], 40)), (0, req([2, 9, 4], 12))]
    _, te, treqs, _ = run_pair(models, knobs, workload,
                               on_tick=expire_after(6, 0))
    assert treqs[0].status == "deadline_missed"
    assert 0 < len(treqs[0].output) < 40
    assert treqs[1].status == "served"
    assert te.pool.n_free == te.pool.n_pages - 1
    assert all(s.free for s in te.slots)


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "bucketed"])
def test_preemption_never_evicts_higher_priority_holder(models, ragged):
    """A tiny pool: every preemption victim is the low-priority request,
    on both engines, and both outputs match."""
    knobs = dict(max_batch=2, max_seq=64, total_pages=5, max_chunk_tokens=8,
                 ragged=ragged)
    workload = [(0, req([11, 5], 38, priority=3)),
                (0, req([7, 19], 38, priority=0))]
    victims = {}

    def spy(eng):
        real = eng._preempt
        got = victims.setdefault(type(eng).__module__, [])

        def preempt(i):
            got.append(eng.slots[i].req.request_id)
            real(i)

        eng._preempt = preempt

    je, te = pair(models, **knobs)
    spy(je)
    spy(te)
    jreqs, jtrace = drive(je, JReq, workload)
    treqs, ttrace = drive(te, TReq, workload)
    assert_same((je, jreqs, jtrace), (te, treqs, ttrace))
    tv = victims[type(te).__module__]
    assert tv and set(tv) == {1}
    assert tv == victims[type(je).__module__]


def test_priority_outranks_fifo_resume_order(models):
    """Mixed priorities, deadlines and a chunked long prompt arriving
    over several ticks, on a tight pool: the SLO order, preemptions and
    chunk packing match tick for tick."""
    rng = np.random.RandomState(5)
    knobs = dict(max_batch=2, max_seq=96, total_pages=8, max_chunk_tokens=8)
    workload = [(0, req(rng.randint(1, 128, 20), 10)),
                (1, req(rng.randint(1, 128, 9), 8, priority=1)),
                (2, req(rng.randint(1, 128, 30), 6, deadline_s=600.0)),
                (2, req(rng.randint(1, 128, 5), 6, priority=2)),
                (4, req(rng.randint(1, 128, 12), 5))]
    _, te, treqs, _ = run_pair(models, knobs, workload)
    assert all(r.status == "served" for r in treqs)


# ---------------------------------------------------- admission control

def test_queue_full_rejects_with_retry_hint(models):
    """max_queue_tokens: the second submit raises QueueFull with the
    cold-engine hint and never enters the queue, in both engines."""
    je, te = pair(models, max_batch=1, max_seq=64, max_queue_tokens=8)
    hints = []
    for eng, cls, exc in ((je, JReq, JQueueFull), (te, TReq, TQueueFull)):
        eng.add_request(cls([1] * 6, max_new_tokens=2))
        with pytest.raises(exc) as ei:
            eng.add_request(cls([1] * 6, max_new_tokens=2))
        hints.append(ei.value.retry_after_s)
        assert len(eng.waiting) == 1
        assert eng.health_snapshot()["accepting"]
    assert hints[0] == hints[1] == 1.0
    assert health(te) == health(je)
    for eng in (je, te):
        while eng.has_work:
            eng.step()
    assert te.finished[0].output == je.finished[0].output


def test_queue_bound_counts_waiting_tokens_only(models):
    """The bound counts the waiting requests' tokens: admitted requests
    free their share, and `accepting` turns back on."""
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8,
                 max_queue_tokens=10)
    je, te = pair(models, **knobs)
    for eng, cls, exc in ((je, JReq, JQueueFull), (te, TReq, TQueueFull)):
        eng.add_request(cls([2] * 6, max_new_tokens=2))
        eng.add_request(cls([3] * 4, max_new_tokens=2))
        assert not eng.health_snapshot()["accepting"]
        with pytest.raises(exc):
            eng.add_request(cls([4], max_new_tokens=2))
        eng.step()                       # the first is admitted
        eng.add_request(cls([5] * 6, max_new_tokens=2))
        while eng.has_work:
            eng.step()
    assert [r.output for r in te.finished] == [r.output for r in je.finished]
    assert health(te) == health(je)


def test_sheds_lowest_priority_most_slack_first(models):
    """Sustained admission starvation sheds the low-priority waiters,
    never the high-priority one; everything terminates."""
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8,
                 max_queue_tokens=200, shed_patience=2)
    workload = [(0, req([3, 5], 30)), (0, req([4, 9], 4, priority=2))]
    workload += [(0, req([6 + i, 2], 4)) for i in range(3)]
    _, te, treqs, _ = run_pair(models, knobs, workload)
    first, hi, lows = treqs[0], treqs[1], treqs[2:]
    assert te.sheds >= 1 and hi.status == "served"
    assert any(r.status == "shed" for r in lows)
    assert all(r.status in ("served", "shed") for r in lows)
    assert first.status == "served"


def test_shed_prefers_the_most_slack(models):
    """Among equal priorities the waiter with the most slack (no
    deadline) goes first, then the latest submitted."""
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8,
                 max_queue_tokens=200, shed_patience=3)
    workload = [(0, req([3, 5], 24)), (0, req([4, 9], 4, deadline_s=900.0)),
                (0, req([6, 2], 4)), (0, req([8, 1], 4, deadline_s=600.0))]
    _, te, treqs, _ = run_pair(models, knobs, workload)
    assert [r.request_id for r in te.finished if r.status == "shed"] == [2]


# ---------------------------------------------------------- degradation

def test_degradation_shrinks_and_recovers_with_hysteresis(models):
    """`_slo_pre_tick` alone on a held pool: halves to the floor, holds
    through the hysteresis window, regrows one step at a time; the same
    trajectory in both engines."""
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=32,
                 min_chunk_tokens=8, degrade_hysteresis=3)
    je, te = pair(models, **knobs)
    trajectories = []
    for eng in (je, te):
        seen = []
        held = eng.pool.alloc(eng.pool.n_free - 1)
        for _ in range(3):
            eng._slo_pre_tick()
            seen.append(eng._eff_chunk)
        eng.pool.free(held)
        for _ in range(6):
            eng._slo_pre_tick()
            seen.append((eng._eff_chunk, eng.health_snapshot()["degraded"]))
        trajectories.append(seen)
    assert trajectories[0] == trajectories[1]
    assert trajectories[1][:3] == [16, 8, 8]
    assert trajectories[1][3:] == [(8, True), (8, True), (16, True),
                                   (16, True), (16, True), (32, False)]


@pytest.mark.parametrize("spec", [True, False], ids=["spec", "no_spec"])
def test_degradation_under_pool_pressure_end_to_end(models, spec):
    """A pool held above the high water by long prompts: the effective
    chunk budget halves under load and regrows after the calm window,
    one packed shape throughout; every request served, the budget
    trajectory tick for tick the reference's."""
    rng = np.random.RandomState(9)
    knobs = dict(max_batch=3, max_seq=96, total_pages=12,
                 max_chunk_tokens=16, min_chunk_tokens=4,
                 degrade_high_water=0.6, degrade_low_water=0.3,
                 degrade_hysteresis=2, speculative=spec)
    workload = [(0, req(rng.randint(1, 128, 60), 8)),
                (0, req(rng.randint(1, 128, 50), 8)),
                (3, req(rng.randint(1, 128, 20), 6)),
                (20, req(rng.randint(1, 128, 30), 6))]
    _, te, treqs, trace = run_pair(models, knobs, workload)
    chunks = [t[3] for t in trace]
    low = chunks.index(min(chunks))
    assert min(chunks) < 16 and max(chunks[low:]) > min(chunks)
    assert te._T_pack == 32
    assert all(r.status == "served" for r in treqs)


def test_degradation_is_ragged_only(models):
    """The bucketed regime has no chunk budget: the controller leaves it
    at max_chunk_tokens whatever the pool holds."""
    je, te = pair(models, max_batch=2, max_seq=64, ragged=False)
    for eng in (je, te):
        held = eng.pool.alloc(eng.pool.n_free - 1)
        eng._slo_pre_tick()
        eng.pool.free(held)
        assert eng._eff_chunk == eng.max_chunk_tokens
    assert health(te) == health(je)


# ----------------------------------------------------------- kill switch

def _mixed_workload():
    prompts = [[9, 4, 2], list(range(1, 20)), [3, 3, 5, 8],
               list(range(2, 30))]
    return [(0, req(p, 6)) for p in prompts]


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "bucketed"])
def test_flag_off_is_the_fifo_engine(models, ragged):
    """FLAGS_serving_slo=0: tokens and the per-tick trace (packed rows,
    finished, preemptions) of the port's kill switch equal the armed
    engine's with inert defaults and the reference's armed engine."""
    knobs = dict(max_batch=2, max_seq=64, total_pages=6, max_chunk_tokens=8,
                 ragged=ragged)
    workload = _mixed_workload()
    _, te, treqs, ttrace = run_pair(models, knobs, workload)
    _, tm = models
    t_core.set_flags({"FLAGS_serving_slo": False})
    try:
        off = TEngine(tm, device="cpu", **knobs)
    finally:
        t_core.set_flags({"FLAGS_serving_slo": True})
    assert not off._slo and te._slo
    oreqs, otrace = drive(off, TReq, workload)
    assert [r.output for r in oreqs] == [r.output for r in treqs]
    assert [t[:3] for t in otrace] == [t[:3] for t in ttrace]
    assert off.preemptions == te.preemptions
    assert off.health_snapshot()["slo_armed"] is False


def test_explicit_kwarg_overrides_flag(models):
    _, tm = models
    t_core.set_flags({"FLAGS_serving_slo": False})
    try:
        assert TEngine(tm, device="cpu", slo=True)._slo
    finally:
        t_core.set_flags({"FLAGS_serving_slo": True})
    assert not TEngine(tm, device="cpu", slo=False)._slo
    assert TEngine(tm, device="cpu")._slo


def test_disarmed_engine_ignores_slo_fields(models):
    """slo=False: priorities and deadlines are carried but not read (the
    FIFO engine), and the queue bound is not enforced."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64, slo=False,
                  max_queue_tokens=4)
    a = TReq([3, 5], max_new_tokens=2)
    b = TReq([7, 9], max_new_tokens=2, priority=9, deadline_s=1e-9)
    eng.add_request(a)
    eng.add_request(b)
    while eng.has_work:
        eng.step()
    assert [r.request_id for r in eng.finished] == [0, 1]
    assert a.status == b.status == "served"
    assert eng.deadline_misses == 0


def test_disarmed_fault_points_are_inert(models):
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64, slo=False)
    eng.add_request(TReq([3, 5], max_new_tokens=2))
    while eng.has_work:
        eng.step()
    assert not t_fi.stats()["enabled"]
    assert eng.finished[0].status == "served"
