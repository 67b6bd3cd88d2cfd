"""Request tracing in the port's serving engine against the JAX
package's armed engine (FLAGS_request_trace on, its default), on the
reference's tiny LLaMA (vocab 128, hidden 64, 2 layers, 4 heads) in fp32
on the CPU, both engines with speculation and the SLO layer armed as
their defaults are. Seeded workloads: a plain burst, preemption on a
small pool (both regimes), drafting on copy-motif prompts, shedding,
deadline misses (waiting and in flight), a cancellation and a tick
fault. For each request the port's ordered events (names and their
counts, the clock's `ttft_s` aside), status, decode ticks, drafted and
accepted counts and the set of buckets charged equal the reference's,
and the buckets sum to the request's wall within 1e-6 s. The kill switch
(`request_trace=False` or FLAGS_request_trace=0) leaves tokens, ticks
and per-tick packed rows equal to the armed run's, with no trace object
and an empty store."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import observability as j_obs
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.models import llama as JL
from paddle_tpu.observability import reqtrace as j_rt
from paddle_tpu.utils import fault_injection as j_fi
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.framework import core as t_core
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.observability import reqtrace as t_rt
from paddle_tpu_torch.utils import fault_injection as t_fi
from tests.test_torch_slo import TINY, drive, expire_after, req

from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL = 1e-6
# event fields that read the clock
CLOCK_FIELDS = ("ts", "ttft_s")


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
    """The fault schedules, metrics registries and trace stores are
    process-wide: start and leave the port's clean and both fault
    schedules disarmed; the reference's traces this file makes leave
    its store."""
    with j_rt._lock:
        j_store = list(j_rt._store.items())
    for fi in (j_fi, t_fi):
        fi.configure(None)
    t_metrics.reset()
    t_rt.clear()
    yield
    for fi in (j_fi, t_fi):
        fi.configure(None)
    for obs in (j_obs, t_obs):
        obs.enable(False)
    t_metrics.reset()
    t_rt.clear()
    with j_rt._lock:
        j_rt._store.clear()
        j_rt._store.update(j_store)


def _copy_motif(rng, tail):
    """A 12-token motif twice, then a tail: the greedy decode quotes the
    context, which the n-gram drafter predicts."""
    motif = rng.randint(1, 128, 12).tolist()
    return motif + motif + rng.randint(1, 128, tail).tolist()


def _scenarios():
    rng = np.random.RandomState(5)
    prefix = rng.randint(1, 128, 16).tolist()

    def cancel_at(tick_no, which):
        def hook(eng, tick, reqs):
            if tick == tick_no:
                eng.cancel_request(reqs[which], reason="client went away")
        return hook

    return {
        # a plain burst: one decoding while a long prompt chunks in, two
        # sharing a one-page prefix (prefix reuse), one arriving later
        "burst": (dict(max_batch=3, max_seq=96, max_chunk_tokens=8),
                  [(0, req([5, 17, 3], 12)),
                   (0, req(rng.randint(1, 128, 30).tolist(), 5)),
                   (1, req(prefix + [11, 12, 13], 4)),
                   (9, req(prefix + [21, 22], 4))], {}),
        "bucketed": (dict(max_batch=2, max_seq=64, max_chunk_tokens=8,
                          ragged=False),
                     [(0, req([5, 17, 3], 9)),
                      (0, req(rng.randint(1, 128, 20).tolist(), 4)),
                      (2, req([7, 9, 11], 5))], {}),
        "preempt": (dict(max_batch=2, max_seq=64, total_pages=5,
                         max_chunk_tokens=8),
                    [(0, req([11, 5], 38)), (0, req([7, 19], 38))], {}),
        "preempt_bucketed": (dict(max_batch=2, max_seq=64, total_pages=5,
                                  max_chunk_tokens=8, ragged=False),
                             [(0, req([11, 5], 38)), (0, req([7, 19], 38))],
                             {}),
        "drafts": (dict(max_batch=2, max_seq=128, max_chunk_tokens=16),
                   [(0, req(_copy_motif(rng, 3), 24)),
                    (0, req(_copy_motif(rng, 5), 24))], {}),
        "shed": (dict(max_batch=1, max_seq=64, max_chunk_tokens=8,
                      max_queue_tokens=200, shed_patience=2),
                 [(0, req([3, 5], 30)), (0, req([4, 9], 4, priority=2))]
                 + [(0, req([6 + i, 2], 4)) for i in range(3)], {}),
        "deadline": (dict(max_batch=2, max_seq=64, max_chunk_tokens=8),
                     [(0, req([3, 5, 7], 40)), (0, req([2, 9, 4], 12)),
                      (0, req([7, 9], 6, deadline_s=1e-9))],
                     {"on_tick": expire_after(6, 0)}),
        "cancel": (dict(max_batch=2, max_seq=64, max_chunk_tokens=8),
                   [(0, req([3, 5, 7], 20)), (0, req([2, 9, 4], 8)),
                    (1, req([4, 4, 2], 6))],
                   {"on_tick": cancel_at(4, 0)}),
        "tick_fault": (dict(max_batch=2, max_seq=64, max_chunk_tokens=8),
                       [(0, req([3, 5, 7], 10)), (0, req([2, 9, 4], 10))],
                       {"faults": "serving.tick:raise@3"}),
    }


SCENARIOS = sorted(_scenarios())


def _events(rec):
    return [{k: v for k, v in e.items() if k not in CLOCK_FIELDS}
            for e in rec["events"]]


def _view(r):
    """What the port must hold equal to the reference, per request."""
    rec = r.trace.snapshot()
    return {"status": rec["status"], "events": _events(rec),
            "decode_ticks": rec["decode_ticks"],
            "spec": (r.spec_drafted, r.spec_accepted),
            "buckets": sorted(rec["buckets"]), "output": list(r.output)}


def _run(eng, req_cls, fi, workload, kw):
    if kw.get("faults"):
        fi.configure(kw["faults"])
    try:
        return drive(eng, req_cls, workload, on_tick=kw.get("on_tick"))
    finally:
        fi.configure(None)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_traces_match_reference(models, scenario):
    jm, tm = models
    knobs, workload, kw = _scenarios()[scenario]
    je = JEngine(jm, **knobs)
    te = TEngine(tm, device="cpu", **knobs)
    assert je._rtrace and te._rtrace and te._slo and te._spec == je._spec
    jreqs, jtrace = _run(je, JReq, j_fi, workload, kw)
    treqs, ttrace = _run(te, TReq, t_fi, workload, kw)
    assert ttrace == jtrace
    for i, (j, t) in enumerate(zip(jreqs, treqs)):
        assert _view(t) == _view(j), f"request {i}"
        rec = t.trace.snapshot()
        assert rec["terminal"] and rec["trace_id"] == t.trace_id
        assert t_rt.lookup(t.trace_id) == rec
        assert min(rec["buckets"].values()) >= 0.0
        assert sum(rec["buckets"].values()) == pytest.approx(
            rec["wall"], abs=TOL)
    # what each scenario is there for happened, on both engines alike
    statuses = [r.status for r in treqs]
    names = {e["ev"] for r in treqs for e in r.trace.snapshot()["events"]}
    want = {"preempt": {"preempted", "resumed"},
            "preempt_bucketed": {"preempted", "resumed"},
            "drafts": {"draft_proposed", "draft_accepted"},
            "burst": {"prefix_reuse"}, "shed": {"shed"},
            "deadline": {"deadline_miss"}, "cancel": {"cancelled"},
            "tick_fault": {"failed"}}.get(scenario, set())
    assert want <= names, (scenario, names)
    if scenario in ("burst", "bucketed", "drafts", "preempt"):
        assert statuses == ["served"] * len(treqs)


@pytest.mark.parametrize("how", ["argument", "flag"])
@pytest.mark.parametrize("ragged", [True, False],
                         ids=["ragged", "bucketed"])
def test_kill_switch_is_bitwise_and_leaves_no_trace(models, how, ragged,
                                                    monkeypatch):
    _, tm = models
    knobs, workload, _ = _scenarios()["preempt" if ragged
                                      else "preempt_bucketed"]
    t_obs.enable(True)
    armed = TEngine(tm, device="cpu", **knobs)
    areqs, atrace = drive(armed, TReq, workload)
    assert armed._rtrace and all(r.trace is not None for r in areqs)
    t_rt.clear()
    t_metrics.reset()
    if how == "flag":
        monkeypatch.setitem(t_core._flags, "FLAGS_request_trace", 0)
        off = TEngine(tm, device="cpu", **knobs)
    else:
        off = TEngine(tm, device="cpu", request_trace=False, **knobs)
    assert not off._rtrace
    oreqs, otrace = drive(off, TReq, workload)
    assert [r.output for r in oreqs] == [r.output for r in areqs]
    assert otrace == atrace
    assert off.ticks == armed.ticks
    assert all(r.trace is None and r.trace_id is None for r in oreqs)
    assert t_rt.traces() == []
    snap = t_metrics.snapshot()
    assert not snap["histograms"].get("serving.attribution_seconds")
    for cells in snap["histograms"].values():
        for cell in cells.values():
            assert "exemplars" not in cell


def test_armed_engine_exemplars_and_attribution(models):
    """With observability armed, every settled bucket lands in
    serving.attribution_seconds with the request's trace id as the
    exemplar, TTFT and TPOT carry exemplars, and each step observes one
    host dispatch wall under its tag (no CUDA events off a card)."""
    _, tm = models
    t_obs.enable(True)
    eng = TEngine(tm, device="cpu", max_batch=2, max_seq=64,
                  max_chunk_tokens=8)
    r = TReq([3, 5, 7], max_new_tokens=4)
    r.trace_id = "ab" * 16
    r.failover_preload_s = 0.5
    eng.add_request(r)
    while eng.has_work:
        eng.step()
    rec = r.trace.snapshot()
    assert rec["trace_id"] == "ab" * 16
    assert rec["buckets"]["failover"] >= 0.5
    assert sum(rec["buckets"].values()) == pytest.approx(rec["wall"],
                                                         abs=TOL)
    snap = t_metrics.snapshot()["histograms"]
    attr = snap["serving.attribution_seconds"]
    assert {k.split("=")[1] for k in attr} == set(rec["buckets"])
    for cell in attr.values():
        assert {ex["trace_id"] for ex in cell["exemplars"].values()} == \
            {"ab" * 16}
    for name in ("serving.ttft_seconds", "serving.tpot_seconds"):
        assert any(c.get("exemplars") for c in snap[name].values())
    steps = snap["xla.dispatch_seconds"]["executable=serving.ragged_step"]
    assert steps["count"] == eng.model_steps
    assert "executable=serving.ragged_step" not in snap["xla.execute_seconds"]
