"""The SLO layer's fault isolation, watchdog, health and telemetry, and
the gateway's SLO wire contract, in the port against the JAX package
(tests/test_serving_slo.py's scenarios on the reference's tiny LLaMA in
fp32 on the CPU; helpers from tests/test_torch_slo.py).

Fault-injected runs arm the same schedule in both packages' own
`fault_injection`. Port-only checks: the watchdog (a timing contract),
errors of a kernel or of the card passing the isolation boundary, the
plain attention routes against stale non-finite values in a reused
page, NaN written into a victim's KV pages, and sampling survivors
under the generator rewind (torch.Generator cannot reproduce
jax.random)."""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import observability as j_obs
from paddle_tpu.inference import gateway as j_gw
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.utils import fault_injection as j_fi
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch import testing
from paddle_tpu_torch.framework import core as t_core
from paddle_tpu_torch.inference import gateway as t_gw
from paddle_tpu_torch.inference import serving as t_serving
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as kpa
from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability import export as t_export
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.utils import fault_injection as t_fi
from tests.test_torch_slo import (assert_same, clean_registries,  # noqa: F401
                                  drive, health, models, pair, req,
                                  run_pair)

from _torch_threads import one_torch_thread  # noqa: F401,E402

ROUTES = pytest.mark.parametrize("ragged", [True, False],
                                 ids=["ragged", "bucketed"])


def arm(spec):
    j_fi.configure(spec)
    t_fi.configure(spec)


def poison_port(monkeypatch, te, ragged, row, call):
    """Make the port's step put NaN in row `row`'s logits on its
    `call`-th run (the real per-row ok computation then sees it)."""
    n = {"calls": 0}
    if ragged:
        real = te._ragged_step

        def step(*a, **kw):
            lg, kp, vp = real(*a, **kw)
            n["calls"] += 1
            if n["calls"] == call:
                lg = lg.clone()
                lg[row] = float("nan")
            return lg, kp, vp

        te._ragged_step = step
    else:
        real = TL._decode_step_paged

        def step(*a, **kw):
            lg, kp, vp = real(*a, **kw)
            n["calls"] += 1
            if n["calls"] == call:
                lg = lg.clone()
                lg[row] = float("nan")
            return lg, kp, vp

        monkeypatch.setattr(TL, "_decode_step_paged", step)


def poison_reference(je, ragged, row, call):
    """Flip the reference step's ok flag of `row` on its `call`-th run
    (its own test's hook)."""
    real = je._ragged_fn() if ragged else je._decode_fn()
    n = {"calls": 0}

    def poisoned(*args):
        nxt, ok, kp, vp = real(*args)
        n["calls"] += 1
        if n["calls"] == call:
            ok = np.asarray(ok).copy()
            ok[row] = False
        return nxt, ok, kp, vp

    if ragged:
        je._compiled_ragged = poisoned
    else:
        je._compiled_decode = poisoned


# ----------------------------------------------------- fault isolation

@ROUTES
def test_poisoned_tick_fails_alone(models, ragged):
    """serving.tick:raise@3 fails the latest admission alone; the others
    are token-identical to the clean run, in both engines."""
    knobs = dict(max_batch=3, max_seq=64, max_chunk_tokens=16,
                 ragged=ragged)
    workload = [(0, req(p, 6)) for p in ([3, 5, 7], [9, 2], [4, 4, 6])]
    _, clean_te, clean, _ = run_pair(models, knobs, workload)
    arm("serving.tick:raise@3")
    _, te, treqs, _ = run_pair(models, knobs, workload)
    assert [r.status for r in treqs] == ["served", "served", "failed"]
    assert "FaultInjected" in treqs[2].error
    assert [r.output for r in treqs[:2]] == [r.output for r in clean[:2]]
    assert te.quarantines == 1 and clean_te.quarantines == 0
    assert te.pool.n_free == te.pool.n_pages - 1
    assert all(s.free for s in te.slots)


@ROUTES
def test_nonfinite_logits_quarantined_exactly(models, monkeypatch, ragged):
    """A row whose logits go non-finite fails exactly its request with
    "non-finite logits"; the other request matches its clean run."""
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=16,
                 ragged=ragged)
    workload = [(0, req([3, 5], 8)), (0, req([7, 9], 8))]
    _, _, clean, _ = run_pair(models, knobs, workload)
    je, te = pair(models, **knobs)
    poison_reference(je, ragged, 1, 3)
    poison_port(monkeypatch, te, ragged, 1, 3)
    jreqs, jtrace = drive(je, JReq, workload)
    treqs, ttrace = drive(te, TReq, workload)
    assert_same((je, jreqs, jtrace), (te, treqs, ttrace))
    a, b = treqs
    assert b.status == "failed" and b.error == "non-finite logits"
    assert a.status == "served" and a.output == clean[0].output
    assert te.quarantines == 1
    assert te.pool.n_free == te.pool.n_pages - 1


@ROUTES
def test_nonfinite_quarantine_rewinds_the_sampling_generator(
        models, monkeypatch, ragged):
    """Sampling (port only: its draws come from torch.Generator): the
    discarded tick's draws rewind with it, so the surviving request's
    sampled tokens equal a clean sampling run's."""
    _, tm = models
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=16, greedy=False,
                 seed=7, ragged=ragged, device="cpu")
    workload = [(0, req([3, 5], 10)), (0, req([7, 9], 10))]
    clean, _ = drive(TEngine(tm, **knobs), TReq, workload)
    te = TEngine(tm, **knobs)
    poison_port(monkeypatch, te, ragged, 1, 3)
    treqs, _ = drive(te, TReq, workload)
    assert treqs[1].status == "failed"
    assert treqs[1].error == "non-finite logits"
    assert treqs[0].status == "served"
    assert treqs[0].output == clean[0].output


def test_page_alloc_fault_fails_one_engine_survives(models):
    arm("serving.page_alloc:raise@2")
    knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=8)
    workload = [(0, req([3 + i, 5], 6)) for i in range(3)]
    _, te, treqs, _ = run_pair(models, knobs, workload)
    statuses = sorted(r.status for r in treqs)
    assert statuses == ["failed", "served", "served"]
    assert te.pool.n_free == te.pool.n_pages - 1


def test_prefix_evict_fault_isolated(models):
    """serving.prefix_evict raising inside an allocation that reclaims
    idle cached pages fails one request; the pool stays whole."""
    rng = np.random.RandomState(3)
    prefix = rng.randint(1, 128, 32).tolist()
    knobs = dict(max_batch=1, max_seq=96, total_pages=6, max_chunk_tokens=32)
    workload = [(0, req(prefix + [5], 2)),
                (3, req(rng.randint(1, 128, 60), 4)),
                (3, req([4, 4, 2], 3))]
    arm("serving.prefix_evict:raise@1")
    _, te, treqs, _ = run_pair(models, knobs, workload)
    assert t_fi.stats()["points"]["serving.prefix_evict"]["triggered"] == 1
    assert te.quarantines == 1
    assert sorted(r.status for r in treqs).count("failed") == 1
    assert te.pool.n_free == te.pool.n_pages - 1


def test_admit_fault_raises_to_caller(models):
    je, te = pair(models, max_batch=1, max_seq=64)
    arm("serving.admit:raise@1")
    for eng, cls, fi in ((je, JReq, j_fi), (te, TReq, t_fi)):
        with pytest.raises(fi.FaultInjected):
            eng.add_request(cls([3, 5], max_new_tokens=2))
        assert eng.waiting == []
        eng.add_request(cls([3, 5], max_new_tokens=2))
        while eng.has_work:
            eng.step()
    assert te.finished[0].output == je.finished[0].output


def test_unattributable_tick_fault_reraises(models):
    """No active slot and no waiter: the exception propagates."""
    je, te = pair(models, max_batch=1, max_seq=64)
    arm("serving.tick:raise@1")
    for eng, fi in ((je, j_fi), (te, t_fi)):
        with pytest.raises(fi.FaultInjected):
            eng.step()


def test_repeated_tick_faults_reraise_after_a_batch(models):
    """More than B + 1 failing ticks in a row are the engine's fault:
    the B + 2nd raises, after B + 1 quarantines, in both engines."""
    je, te = pair(models, max_batch=1, max_seq=64)
    spec = ",".join(f"serving.tick:raise@{n}" for n in range(1, 6))
    arm(spec)
    for eng, cls, fi in ((je, JReq, j_fi), (te, TReq, t_fi)):
        for i in range(4):
            eng.add_request(cls([3 + i, 5], max_new_tokens=2))
        eng.step()
        eng.step()
        with pytest.raises(fi.FaultInjected):
            eng.step()
    assert te.quarantines == je.quarantines == 2
    assert [r.status for r in te.finished] == [r.status for r in je.finished]


def test_delay_fault_trips_engine_watchdog(models):
    """serving.tick:delay of 0.4 s against a 0.1 s tick timeout: the
    engine's private watchdog fires, naming serving.tick."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64,
                  max_chunk_tokens=8, tick_timeout_s=0.1)
    eng.add_request(TReq([3, 5], max_new_tokens=2))
    t_fi.configure("serving.tick:delay:0.4@2")
    with pytest.warns(RuntimeWarning, match="serving.tick"):
        while eng.has_work:
            eng.step()
    assert eng._wd.timeouts >= 1
    assert eng.finished[0].status == "served"
    eng._wd.shutdown()


def test_watchdog_sections():
    """CommWatchdog alone: an overrun section fires once, counts and
    warns with its name; a section that ends in time does not fire; the
    counter lands in the metrics registry while it is armed; the modes
    not ported raise."""
    from paddle_tpu_torch.distributed.watchdog import CommWatchdog
    t_obs.enable(True)
    wd = CommWatchdog(timeout=0.1, on_timeout="warn")
    with wd.section("quick"):
        time.sleep(0.01)
    assert wd.timeouts == 0
    with pytest.warns(RuntimeWarning, match="'slow'"):
        with wd.section("slow"):
            time.sleep(0.4)
    wd.shutdown()
    assert wd.timeouts == 1
    snap = t_metrics.snapshot()["counters"]["watchdog.timeouts_total"]
    assert snap == {"section=slow": 1}
    with pytest.raises(NotImplementedError, match="abort"):
        CommWatchdog(timeout=1.0, on_timeout="abort")


_DEVICE_FAULTS = {
    "build": lambda: _build.KernelError("nvcc failed:\nragged.cu: error"),
    "launch": lambda: _build.KernelError(
        "ragged_paged_attention: CUDA launch failed with error 700"),
    "cuda_runtime": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "cublas": lambda: RuntimeError(
        "CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling "
        "`cublasGemmEx`"),
    "out_of_memory": lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
}


@ROUTES
@pytest.mark.parametrize("kind", sorted(_DEVICE_FAULTS))
def test_device_errors_pass_the_isolation_boundary(models, monkeypatch,
                                                   ragged, kind):
    """A kernel's build, load or launch failure and the card's own errors
    raise out of step() unchanged: no request is quarantined, where the
    reference quarantines whatever a tick raises (ROADMAP Queue 3)."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=2, max_seq=64,
                  max_chunk_tokens=16, ragged=ragged)
    reqs = [TReq([3, 5], max_new_tokens=6), TReq([7, 9], max_new_tokens=6)]
    for r in reqs:
        eng.add_request(r)
    eng.step()                           # admitted and prefilled
    exc = _DEVICE_FAULTS[kind]()
    assert _build.is_device_fault(exc)

    def boom(*a, **kw):
        raise exc

    mod, name = ((krpa, "ragged_paged_attention") if ragged
                 else (kpa, "paged_decode_attention"))
    monkeypatch.setattr(mod, name, boom)
    with pytest.raises(type(exc)) as got:
        eng.step()
    assert got.value is exc
    assert eng.quarantines == 0
    assert [r.status for r in reqs] == ["running", "running"]


@ROUTES
def test_request_errors_are_quarantined_not_raised(models, monkeypatch,
                                                   ragged):
    """The same wrapper raising an error that is neither a kernel's nor
    the card's fails one request (the latest admission), as in the
    reference; the engine goes on."""
    _, tm = models
    eng = TEngine(tm, device="cpu", max_batch=2, max_seq=64,
                  max_chunk_tokens=16, ragged=ragged)
    reqs = [TReq([3, 5], max_new_tokens=4), TReq([7, 9], max_new_tokens=4)]
    for r in reqs:
        eng.add_request(r)
    eng.step()
    mod, name = ((krpa, "ragged_paged_attention") if ragged
                 else (kpa, "paged_decode_attention"))
    real = getattr(mod, name)
    calls = {"n": 0}

    def once(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("shape mismatch in a poisoned request")
        return real(*a, **kw)

    monkeypatch.setattr(mod, name, once)
    while eng.has_work:
        eng.step()
    assert [r.status for r in reqs] == ["served", "failed"]
    assert reqs[1].error.startswith("RuntimeError: shape mismatch")
    assert eng.quarantines == 1


# --------------------------------------- stale non-finite values in pages

_SPLIT = types.SimpleNamespace(
    ragged_paged_attention=lambda q, k, v, qs, ql, kl, pt: krpa._split_plain(
        q, k, v, qs, ql, kl, pt, q.shape[-1] ** -0.5),
    paged_decode_attention=lambda q, k, v, ln, pt: kpa._split_plain(
        q, k, v, ln, pt, q.shape[-1] ** -0.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["plain", "split_plain"])
def test_plain_routes_nonfinite_semantics(route, dtype):
    """A reused page keeps the previous owner's values past the new
    owner's length: NaN keys and inf values there, in the scratch page
    and in a free page must not reach the output (the plain routes select
    masked keys out of V: a weight of 0 times inf or NaN is NaN), while a
    NaN key a sequence does see makes exactly its rows NaN
    (`testing.nonfinite_checks`, which the card runs on rows 9 and 13)."""
    mods = ((krpa, kpa) if route == "plain" else (_SPLIT, _SPLIT))
    got = testing.nonfinite_checks(*mods, getattr(torch, dtype), "cpu")
    assert len(got) == 9
    assert [label for label, ok in got if not ok] == []


@ROUTES
def test_nan_pages_quarantine_exactly_one(models, ragged):
    """chip_smoke.py's phase 6b (c) on the CPU: NaN written into a
    victim's KV pages after its prefill quarantines exactly it; the
    others are token-identical to a clean run; a request on the victim's
    reclaimed pages (stale NaN past its length) is token-identical to a
    fresh engine's."""
    _, tm = models
    knobs = dict(max_batch=3, max_seq=96, max_chunk_tokens=32,
                 ragged=ragged, device="cpu")
    rng = np.random.RandomState(23)
    prompts = [rng.randint(1, 128, n).tolist() for n in (40, 30, 12)]
    workload = [(0, req(p, 10)) for p in prompts]
    clean, _ = drive(TEngine(tm, **knobs), TReq, workload)
    eng = TEngine(tm, **knobs)
    hit = {}

    def poison(e, tick, reqs):
        victim = reqs[2]
        if hit or victim.status != "running":
            return
        i = next(j for j, s in enumerate(e.slots) if s.req is victim)
        if e.slots[i].pending or not victim.output:
            return
        hit["pages"] = list(e.slot_pages[i])
        e.k_pool[:, :, hit["pages"]] = float("nan")
        e.v_pool[:, :, hit["pages"]] = float("nan")

    reqs, _ = drive(eng, TReq, workload, on_tick=poison)
    assert hit and reqs[2].status == "failed"
    assert reqs[2].error == "non-finite logits"
    assert eng.quarantines == 1
    assert [r.output for r in reqs[:2]] == [r.output for r in clean[:2]]
    free = eng.pool._free
    for p in hit["pages"]:
        free.remove(p)
    free.extend(reversed(hit["pages"]))
    late = [(0, req([5, 9, 17, 2, 11], 12))]
    seen = set()

    def pages(e, tick, rs):
        for j, s in enumerate(e.slots):
            if s.req is rs[0]:
                seen.update(e.slot_pages[j])

    got, _ = drive(eng, TReq, late, on_tick=pages)
    want, _ = drive(TEngine(tm, **knobs), TReq, late)
    assert seen & set(hit["pages"])
    assert got[0].status == "served" and got[0].output == want[0].output


# ------------------------------------------------------ health, metrics

def test_health_snapshot_and_healthz_payload(models):
    je, te = pair(models, max_batch=2, max_seq=64, max_queue_tokens=100)
    for eng, cls in ((je, JReq), (te, TReq)):
        eng.add_request(cls([3, 5], max_new_tokens=2))
    snap = te.health_snapshot()
    assert snap["ready"] and snap["slo_armed"] and snap["accepting"]
    assert snap["queue_depth"] == 1 and snap["queued_tokens"] == 2
    assert snap["kv_pages"]["total"] == te.pool.n_pages - 1
    assert snap["effective_chunk_tokens"] == te.max_chunk_tokens
    assert health(te) == health(je)
    payload = t_export.health_payload()
    assert payload["ok"]
    assert any(e["queue_depth"] == 1 and e["device"] == "cpu"
               for e in payload["serving"]["engines"])
    assert any(e["device"] == "cpu" and e["queue_depth"] == 1
               for e in t_serving.serving_health()["engines"])
    t_export.register_health_provider("broken", lambda: 1 / 0)
    try:
        bad = t_export.health_payload()
        assert not bad["ok"] and "ZeroDivisionError" in bad["broken"]["error"]
    finally:
        t_export.unregister_health_provider("broken")
    for eng in (je, te):
        while eng.has_work:
            eng.step()
    assert health(te) == health(je)


def _metric_cells(snap):
    """The snapshot's serving.* cells that do not read the wall clock:
    counters and the non-timing gauges by value, histograms by count."""
    out = {}
    for kind in ("counters", "gauges"):
        for name, cells in snap[kind].items():
            if name.startswith("serving.") and cells:
                out[(kind, name)] = cells
    for name, cells in snap["histograms"].items():
        if name.startswith("serving.") and cells:
            out[("histograms", name)] = {k: c["count"]
                                         for k, c in cells.items()}
    return out


def test_slo_counters_and_priority_labels(models):
    """Metrics armed in both packages: the serving.* counters, gauges
    and histogram counts (TTFT and TPOT labeled by priority, and the
    request-trace attribution by bucket) agree, both engines with
    request tracing armed as their defaults arm it."""
    for obs in (j_obs, t_obs):
        obs.enable(True)
    knobs = dict(max_batch=1, max_seq=64, max_chunk_tokens=8,
                 max_queue_tokens=200, shed_patience=2)
    workload = [(0, req([3, 5], 25, priority=1))]
    workload += [(0, req([6 + i, 2], 4)) for i in range(3)]
    workload += [(0, req([2, 2], 4, deadline_s=1e-9))]
    jm, tm = models
    je = JEngine(jm, slo=True, **knobs)
    te = TEngine(tm, device="cpu", **knobs)
    assert je._rtrace and te._rtrace
    drive(je, JReq, workload)
    jcells = _metric_cells(j_metrics.snapshot())
    drive(te, TReq, workload)
    tcells = _metric_cells(t_metrics.snapshot())
    assert tcells == jcells
    assert tcells[("counters", "serving.deadline_misses_total")][""] == 1
    assert tcells[("counters", "serving.sheds_total")][""] >= 1
    assert ("gauges", "serving.queue_depth") in tcells
    ttft = tcells[("histograms", "serving.ttft_seconds")]
    assert any("priority=" in k for k in ttft)
    assert ("histograms", "serving.attribution_seconds") in tcells


def test_metrics_disarmed_by_default_and_armed_by_flag(models):
    """The registry records nothing until FLAGS_metrics (or enable())
    arms it; set_flags routes the flag to the registry."""
    _, tm = models
    assert not t_obs.enabled()
    eng = TEngine(tm, device="cpu", max_batch=1, max_seq=64)
    eng.add_request(TReq([4, 9], max_new_tokens=3))
    while eng.has_work:
        eng.step()
    snap = t_metrics.snapshot()
    assert not snap["counters"].get("serving.preemptions_total")
    assert not snap["histograms"]["serving.ttft_seconds"]
    t_core.set_flags({"FLAGS_metrics": True})
    try:
        assert t_obs.enabled()
        eng.add_request(TReq([4, 9], max_new_tokens=3))
        while eng.has_work:
            eng.step()
        ttft = t_metrics.snapshot()["histograms"]["serving.ttft_seconds"]
        assert ttft["priority=0"]["count"] == 1
    finally:
        t_core.set_flags({"FLAGS_metrics": False})
    assert not t_obs.enabled()


@pytest.mark.parametrize("spec", [
    "serving.tick:raise@2", "serving.tick:delay:0.001@1,serving.admit:"
    "raise:TimeoutError@3", "a.b:raise;c.d:crash:3@4", "x.y:torn_write@2"])
def test_fault_schedule_grammar_matches_reference(spec):
    """The same schedule gives the same stats and the same raises in
    both packages' fault_injection (FLAGS_fault_inject routes there)."""
    t_core.set_flags({"FLAGS_fault_inject": spec})
    j_fi.configure(spec)
    assert t_fi.stats() == j_fi.stats()
    for point in ("serving.tick", "serving.tick", "serving.admit",
                  "serving.admit", "serving.admit"):
        outcomes = []
        for fi in (j_fi, t_fi):
            try:
                fi.fault_point(point)
                outcomes.append(None)
            except Exception as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1]
    assert t_fi.stats() == j_fi.stats()
    t_core.set_flags({"FLAGS_fault_inject": ""})
    assert not t_fi.enabled()


@pytest.mark.parametrize("bad", ["nocolon", "p:explode", "p:raise@0",
                                 "p:raise:KeyError", "p:delay:soon",
                                 "p:torn_write:1"])
def test_fault_schedule_errors_match_reference(bad):
    for fi in (j_fi, t_fi):
        with pytest.raises(fi.FaultConfigError):
            fi.configure(bad)


# --------------------------------------------------------- the gateway

def _post(port, body, timeout=60):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read().decode()


def _post_err(port, body):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, body)
    return err.value.code, dict(err.value.headers), json.loads(
        err.value.read())


def test_gateway_status_codes_match_reference():
    assert t_gw._STATUS_HTTP == j_gw._STATUS_HTTP


def test_gateway_queue_full_answers_429(models):
    """Two prompts queued together against a bound that holds one: the
    second answers 429 with an integer Retry-After in [1, 60] and the
    engine's hint in the body; /healthz reads 503 while the queue is
    full; the first is served."""
    _, tm = models
    eng = t_gw.build_engine(tm, max_batch=1, max_seq=64, device="cpu",
                            max_queue_tokens=10)
    assert eng.max_queue_tokens == 10
    assert t_gw.build_engine(tm, max_seq=64,
                             device="cpu").max_queue_tokens == 512
    runner = t_gw.EngineRunner(eng)
    gateway = t_gw.ServingGateway(runner, port=0)
    port = gateway.start()
    got = {}

    def post(i, body):
        try:
            got[i] = _post(port, body)
        except urllib.error.HTTPError as e:
            got[i] = (e.code, dict(e.headers), e.read().decode())

    bodies = [{"prompt": [1] * 8, "max_new_tokens": 2, "stream": False},
              {"prompt": [2] * 8, "max_new_tokens": 2, "stream": False}]
    threads = [threading.Thread(target=post, args=(i, b))
               for i, b in enumerate(bodies)]
    try:
        with runner.lock:
            for i, t in enumerate(threads):
                t.start()
                t0 = time.monotonic()
                while len(runner._inbox) <= i:
                    assert time.monotonic() - t0 < 30
                    time.sleep(0.001)
        for t in threads:
            t.join(timeout=60)
        assert got[0][0] == 200
        assert json.loads(got[0][2])["status"] == "served"
        code, headers, body = got[1]
        assert code == 429
        assert 1 <= int(headers["Retry-After"]) <= 60
        assert json.loads(body)["retry_after_s"] > 0
        runner.stop()                    # no tick takes the next one
        eng.add_request(TReq([3] * 10, max_new_tokens=2))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=30)
        assert err.value.code == 503
        assert int(err.value.headers["Retry-After"]) >= 1
    finally:
        gateway.stop()


def test_gateway_deadline_answers_504_and_error_frame(models):
    _, tm = models
    eng = TEngine(tm, max_batch=1, max_seq=64, device="cpu")
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        code, _, body = _post_err(port, {"prompt": [1, 2, 3],
                                         "max_new_tokens": 2,
                                         "deadline_s": 1e-9,
                                         "stream": False})
        assert code == 504 and body["status"] == "deadline_missed"
        _, _, text = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2,
                                  "deadline_s": 1e-9})
        frames = [f for f in text.split("\n\n") if f.startswith("event:")]
        assert frames and frames[-1].startswith("event: error")
        end = json.loads(frames[-1].split("data: ", 1)[1])
        assert end["status"] == "deadline_missed"
        _, _, text = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2,
                                  "priority": 3, "deadline_s": 600.0})
        assert "event: end" in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            h = json.loads(resp.read())["engine"]
        assert h["slo_armed"] and not h["degraded"]
        assert h["counters"]["deadline_misses"] == 2
        assert h["effective_chunk_tokens"] == h["max_chunk_tokens"]
    finally:
        gateway.stop()


def test_gateway_http_request_fault_point(models):
    """serving.http_request raising answers that one POST 500; the next
    is served."""
    _, tm = models
    eng = TEngine(tm, max_batch=1, max_seq=64, device="cpu")
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        t_fi.configure("serving.http_request:raise@1")
        code, _, body = _post_err(port, {"prompt": [1, 2, 3],
                                         "max_new_tokens": 2,
                                         "stream": False})
        assert code == 500 and "FaultInjected" in body["error"]
        t_fi.configure(None)
        status, _, text = _post(port, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 2,
                                       "stream": False})
        assert status == 200 and json.loads(text)["status"] == "served"
    finally:
        gateway.stop()


def test_gateway_admit_fault_answers_503(models):
    """serving.admit raising on the tick thread comes back to the
    submitting handler (a RuntimeError: 503, as in the reference) and
    the engine keeps serving."""
    _, tm = models
    eng = TEngine(tm, max_batch=1, max_seq=64, device="cpu")
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        t_fi.configure("serving.admit:raise@1")
        code, headers, body = _post_err(port, {"prompt": [1, 2, 3],
                                               "max_new_tokens": 2,
                                               "stream": False})
        assert code == 503 and "serving.admit" in body["error"]
        assert headers["Retry-After"] == "1"
        status, _, text = _post(port, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 2,
                                       "stream": False})
        assert status == 200 and json.loads(text)["status"] == "served"
        assert gateway.runner.fatal is None
    finally:
        gateway.stop()
