"""The port's request-trace, metrics-export and goodput modules against
the JAX package's on the same inputs (no model): trace-header parsing,
RequestTrace ledgers and timelines at fixed clock values, the bounded
LRU store, the JSONL sink, the Prometheus text of the same registry
content (counters, labelled gauges, histograms with exemplars), goodput
windows and the arm() refcount. Wall-clock fields (`ts`, exemplar
timestamps) are the only values set aside, and only where each package
reads its own clock.

Both packages keep these registries process-wide: the autouse fixture
starts and leaves the port's reset, and every reference registry a test
writes is restored by the same fixture."""
import json

import pytest

from paddle_tpu import observability as j_obs
from paddle_tpu.observability import export as j_export
from paddle_tpu.observability import goodput as j_goodput
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.observability import reqtrace as j_rt
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch.observability import export as t_export
from paddle_tpu_torch.observability import goodput as t_goodput
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.observability import reqtrace as t_rt
from paddle_tpu_torch.observability import spans as t_spans

from _torch_threads import one_torch_thread  # noqa: F401,E402

TOL = 1e-6
PACKAGES = (("jax", j_obs, j_metrics, j_rt, j_goodput, j_export),
            ("torch", t_obs, t_metrics, t_rt, t_goodput, t_export))
# instruments this file registers in both registries (dropped after
# each test so no other test's registry view sees them)
TEST_IDS = ("porttest.requests_total", "porttest.bytes_total",
            "porttest.queue_depth", "porttest.latency_seconds",
            "porttest.rows")


def _reset_port():
    t_obs.enable(False)
    t_metrics.reset()
    t_spans.clear()
    t_rt.set_sink(None)
    t_rt.clear()
    t_rt.set_store_size(1024)
    t_goodput.reset()


@pytest.fixture(autouse=True)
def clean():
    _reset_port()
    with j_rt._lock:
        j_state = (j_metrics.enabled(), list(j_rt._store.items()),
                   j_rt._store_max)
    yield
    _reset_port()
    for mod in (j_metrics, t_metrics):
        with mod._lock:
            for name in TEST_IDS:
                mod._instruments.pop(name, None)
    enabled, store, store_max = j_state
    j_rt.set_sink(None)
    with j_rt._lock:
        j_rt._store.clear()
        j_rt._store.update(store)
        j_rt._store_max = store_max
    j_goodput.reset()
    j_metrics.enable(enabled)


def _no_ts(obj):
    """A record with every wall-clock timestamp (`ts`) dropped."""
    if isinstance(obj, dict):
        return {k: _no_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_no_ts(v) for v in obj]
    return obj


# -------------------------------------------------------------- trace ids

HEADERS = [None, "", "DEADBEEF", "deadbeef", "  a1b2c3d4e5f60718  ",
           "00-" + "a" * 32 + "-00f067aa0ba902b7-01",
           "00-" + "C0FFEE00" * 4 + "-00f067aa0ba902b7-01", "not hex!",
           "ab", "x" * 70, "f" * 64, "f" * 65, "-", "00-", "00-zz-01",
           "1234567", "12345678", "0" * 32]


@pytest.mark.parametrize("value", HEADERS, ids=range(len(HEADERS)))
def test_parse_trace_header_matches_reference(value):
    assert t_rt.parse_trace_header(value) == j_rt.parse_trace_header(value)


def test_minted_ids_are_traceparent_width():
    tids = {t_rt.mint_trace_id() for _ in range(64)}
    assert len(tids) == 64
    for tid in tids:
        assert len(tid) == 32 and t_rt.parse_trace_header(tid) == tid


# ------------------------------------------------------------ the ledger

def _ledger_script(rt, script):
    """Run (op, args) on a fresh RequestTrace of each package; returns the
    terminal record or the snapshot."""
    tr = rt.RequestTrace("feedc0de" * 4, now=100.0)
    rec = None
    for op, args, kw in script:
        out = getattr(tr, op)(*args, **kw)
        if op == "finish":
            rec = out
    return rec if rec is not None else tr.snapshot(), tr


SCRIPTS = {
    "served": [
        ("event", ("arrival",), {"prompt_tokens": 5, "priority": 0}),
        ("charge", ("queue_wait",), {"now": 100.5}),
        ("event", ("admitted",), {"cached_pages": 0}),
        ("event", ("prefill_chunk",), {"tokens": 5, "pages": 1}),
        ("charge", ("prefill_compute",), {"now": 101.25}),
        ("event", ("first_token",), {"ttft_s": 1.25}),
        *[("event", ("decode_tick",), {})] * 7,
        *[("charge", ("decode_compute",), {"now": 101.25 + 0.125 * i})
          for i in range(1, 8)],
        ("event", ("draft_proposed",), {"n": 4}),
        ("event", ("draft_accepted",), {"n": 1}),
        ("event", ("draft_rejected",), {"n": 3}),
        ("charge", ("draft_overhead",), {"now": 102.5}),
        ("charge", ("stream_write",), {"now": 102.75}),
        ("finish", ("served", "finished"), {"now": 102.75, "n_tokens": 7}),
    ],
    "preempted": [
        ("charge", ("queue_wait",), {"now": 100.25}),
        ("event", ("preempted",), {}),
        ("charge", ("preempted",), {"now": 101.0}),
        ("event", ("resumed",), {"tokens": 9, "pages": 1}),
        ("charge", ("page_wait",), {"now": 101.5}),
        ("charge", ("page_wait",), {"now": 101.75}),
        ("finish", ("cancelled", "cancelled"),
         {"now": 101.75, "error": "client disconnected"}),
    ],
    "failover": [
        ("preload", ("failover", 0.75), {}),
        ("preload", ("failover", 0.0), {}),
        ("charge", ("queue_wait",), {"now": 100.5}),
        ("finish", ("shed", "shed"), {"now": 100.5}),
        ("finish", ("served", "finished"), {"now": 999.0}),
    ],
    "open": [
        ("event", ("arrival",), {"prompt_tokens": 3}),
        ("charge", ("queue_wait",), {"now": 100.125}),
        *[("event", ("decode_tick",), {"n": 2})] * 3,
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_request_trace_matches_reference(script):
    """Charges, events (decode_tick coalesced), preload and an idempotent
    finish at fixed clock values give equal snapshots; the buckets sum
    to the wall."""
    jrec, _ = _ledger_script(j_rt, SCRIPTS[script])
    trec, ttr = _ledger_script(t_rt, SCRIPTS[script])
    assert _no_ts(trec) == _no_ts(jrec)
    if trec["terminal"]:
        assert sum(trec["buckets"].values()) == pytest.approx(
            trec["wall"], abs=TOL)
    assert ttr.pending_bucket == _ledger_script(
        j_rt, SCRIPTS[script])[1].pending_bucket


@pytest.mark.parametrize("call", [
    ("charge", ("gpu_time",)), ("event", ("prefil_chunk",)),
    ("finish", ("served", "arrival")), ("preload", ("compile", 1.0))])
def test_unregistered_names_raise_in_both(call):
    op, args = call
    for rt in (j_rt, t_rt):
        with pytest.raises(ValueError):
            getattr(rt.RequestTrace("t"), op)(*args)


def test_taxonomy_is_the_reference_taxonomy():
    assert t_rt.EVENTS == j_rt.EVENTS
    assert t_rt.BUCKETS == j_rt.BUCKETS
    assert t_rt._TERMINAL_EVENTS == j_rt._TERMINAL_EVENTS


def test_store_is_the_same_bounded_lru():
    """The same new/lookup sequence on both stores: the same ids survive,
    in the same order; re-requesting an id refreshes it."""
    for rt in (j_rt, t_rt):
        rt.clear()
        rt.set_store_size(4)
    ops = [f"{i:08x}" for i in range(6)] + ["00000003", "00000006",
                                            "00000007", "00000003"]
    for rt in (j_rt, t_rt):
        for tid in ops:
            rt.new_trace(tid, now=1.0)
    assert t_rt.traces() == j_rt.traces()
    assert len(t_rt.traces()) == 4
    assert t_rt.lookup("00000000") is None
    assert t_rt.get_trace("00000003") is t_rt.new_trace("00000003")
    assert _no_ts(t_rt.lookup("00000007")) == _no_ts(j_rt.lookup("00000007"))
    t_rt.set_store_size(2)
    j_rt.set_store_size(2)
    assert t_rt.traces() == j_rt.traces()


def test_sink_jsonl_round_trip(tmp_path):
    """Each package's sink writes the same records (every non-coalesced
    event live, the terminal record at finish), one flushed line each."""
    recs = {}
    for name, rt in (("jax", j_rt), ("torch", t_rt)):
        path = str(tmp_path / name / "trace.jsonl")
        rt.set_sink(path)
        assert rt.sink_path() == path
        tr = rt.new_trace("feedc0de" * 4, now=5.0)
        tr.event("arrival", prompt_tokens=3)
        tr.event("decode_tick")
        tr.charge("queue_wait", now=5.5)
        with open(path) as f:
            assert [json.loads(ln)["ev"] for ln in f] == ["arrival"]
        tr.finish("served", "finished", now=5.5, n_tokens=2)
        rt.set_sink(None)
        with open(path) as f:
            recs[name] = [json.loads(ln) for ln in f]
    assert [r["ev"] for r in recs["torch"]] == ["arrival", "finished",
                                                "terminal"]
    assert _no_ts(recs["torch"]) == _no_ts(recs["jax"])
    term = recs["torch"][-1]
    assert term["status"] == "served" and term["decode_ticks"] == 1
    assert sum(term["buckets"].values()) == pytest.approx(term["wall"],
                                                          abs=TOL)


# ------------------------------------------------------- metrics export

def _fill(metrics):
    """The same registry content in one package: counters with and
    without labels (an escaped value among them), a labelled gauge, and
    histograms with exemplars in a bounded and the +Inf bucket."""
    metrics.enable(True)
    c = metrics.counter("porttest.requests_total", "requests by code")
    c.inc(code="200")
    c.inc(3, code="200")
    c.inc(code="50,0=x\\")
    b = metrics.counter("porttest.bytes_total")
    b.inc(2 ** 40 + 7)
    b.inc(0.25)
    g = metrics.gauge("porttest.queue_depth", "queue depth by engine")
    g.set(4, engine="a")
    g.set(1.5e-7, engine='q"uote\nnl')
    h = metrics.histogram("porttest.latency_seconds", "latency",
                          buckets=(0.01, 0.1, 1.0))
    h.observe(0.005, exemplar="aa" * 16, route="x")
    h.observe(0.05, route="x")
    h.observe(0.07, exemplar="bb" * 16, route="x")
    h.observe(5.0, exemplar="cc" * 16, route="x")
    h.observe(0.5, route="y")
    r = metrics.histogram("porttest.rows", buckets=(1.0, 8.0))
    r.observe(3.0)
    snap = metrics.snapshot()
    out = {}
    for kind in ("counters", "gauges", "histograms"):
        out[kind] = {k: v for k, v in snap[kind].items()
                     if k in TEST_IDS}
    for cells in out["histograms"].values():
        for cell in cells.values():
            for ex in cell.get("exemplars", {}).values():
                ex["ts"] = 1700000000.25       # each package's own clock
    return out


def test_prometheus_text_byte_equal_to_reference():
    jsnap = _fill(j_metrics)
    tsnap = _fill(t_metrics)
    assert tsnap == jsnap
    ttext = t_export.prometheus_text(tsnap)
    assert ttext == j_export.prometheus_text(jsnap)
    assert '# {trace_id="' + "cc" * 16 + '"} 5 1700000000.25' in ttext
    assert "porttest_bytes_total 1099511627783.25" in ttext


def test_histogram_exemplars_match_reference():
    """The exemplar a bucket keeps is the last one observed into it."""
    for metrics in (j_metrics, t_metrics):
        metrics.enable(True)
        h = metrics.histogram("porttest.rows", buckets=(1.0, 8.0))
        h.observe(0.5, exemplar="first")
        h.observe(0.75, exemplar="second")
        h.observe(2.0)
    js = j_metrics.instruments()["porttest.rows"].snapshot()
    ts = t_metrics.instruments()["porttest.rows"].snapshot()
    assert _no_ts(ts) == _no_ts(js)
    assert ts[""]["exemplars"]["1"]["trace_id"] == "second"
    assert set(ts[""]["exemplars"]) == {"1"}


@pytest.mark.parametrize("key", ["", "a=1", "a=1,b=x\\,y", "k=v\\=w",
                                 "k=trail\\\\", "a=,b="])
def test_split_label_key_matches_reference(key):
    assert t_metrics.split_label_key(key) == j_metrics.split_label_key(key)


@pytest.mark.parametrize("path", ["/metrics", "", "/healthz", "/nope",
                                  "/metrics?x=1"])
def test_http_get_payload_routes(path):
    """The shared GET surface: /metrics (text), /healthz (JSON), None for
    an unknown path — the reference's statuses and content types."""
    tgot = t_export.http_get_payload(path)
    jgot = j_export.http_get_payload(path)
    if jgot is None:
        assert tgot is None
        return
    assert tgot[:2] == jgot[:2]
    if path.startswith("/healthz"):
        assert json.loads(tgot[2])["ok"] is True


# -------------------------------------------------------------- goodput

def _waiting_source(goodput):
    """Two items; a prefetcher's wait reported inside next(), which the
    enclosing timed_iter already times (so it is not counted again)."""
    for i in range(2):
        goodput.consumer_wait(1.0)
        yield i


WINDOWS = [{"data_wait": 0.002, "compile": 0.001},
           {}, {"checkpoint_stall": 0.0005, "data_wait": 0.0},
           {"host_pull": 0.003}]


def test_goodput_windows_match_reference():
    """The same attributions in the same windows: per-window badput
    dicts and the cumulative badput equal the reference's; in both,
    productive + badput == the window wall, and the summary's wall is
    their sum."""
    got = {}
    for name, obs, metrics, _, goodput, _ in PACKAGES:
        metrics.enable(True)
        metrics.reset()
        goodput.reset()
        assert goodput.step_boundary() is None       # opens a window
        wins = []
        for w in WINDOWS:
            for cat, s in w.items():
                goodput.attribute(cat, s)
            with goodput.time_section("elastic_barrier"):
                pass
            for _ in goodput.timed_iter(_waiting_source(goodput),
                                        category="other"):
                pass
            out = goodput.step_boundary()
            assert out["productive"] == pytest.approx(
                max(0.0, out["wall"] - sum(out["badput"].values())),
                abs=1e-12)
            assert out["mfu"] == 0.0
            # the two timed categories read each package's own clock
            wins.append({k: v for k, v in out["badput"].items()
                         if k not in ("elastic_barrier", "other")})
        summ = goodput.summary()
        assert summ["steps"] == len(WINDOWS)
        assert summ["wall_seconds"] == pytest.approx(
            summ["productive_seconds"]
            + sum(summ["badput_seconds"].values()), abs=1e-12)
        snap = metrics.snapshot()
        assert snap["counters"]["goodput.steps_total"][""] == len(WINDOWS)
        got[name] = (wins, sorted(summ["badput_seconds"]))
        goodput.reset()
        metrics.reset()
    assert got["torch"] == got["jax"]


def test_goodput_disarmed_is_inert():
    t_goodput.attribute("compile", 5.0)
    assert t_goodput.step_boundary() is None
    assert t_goodput.summary()["steps"] == 0


def test_peak_flops_override_and_cpu(monkeypatch):
    monkeypatch.setenv("PADDLE_PEAK_FLOPS", "1.5e12")
    assert t_goodput.peak_flops_per_sec() == 1.5e12
    monkeypatch.delenv("PADDLE_PEAK_FLOPS")
    monkeypatch.setattr(t_goodput, "_peak_cache", None)
    import torch
    if not torch.cuda.is_available():
        assert t_goodput.peak_flops_per_sec() == 0.0
    elif "H100" in torch.cuda.get_device_name(0):
        assert t_goodput.peak_flops_per_sec() == 989e12


# --------------------------------------------------------- the arm() count

def test_arm_refcount_matches_reference():
    """Two overlapping armers: the first restore leaves telemetry armed,
    the last restores the state before the first arm; a second call of
    one restore is a no-op — the same states in both packages."""
    seen = {}
    for name, obs, metrics, *_ in PACKAGES:
        obs.enable(False)
        states = []
        r1 = obs.arm()
        states.append(metrics.enabled())
        r2 = obs.arm()
        r1()
        r1()
        states.append(metrics.enabled())
        r2()
        states.append(metrics.enabled())
        obs.enable(True)
        r3 = obs.arm()
        r3()
        states.append(metrics.enabled())
        obs.enable(False)
        seen[name] = states
    assert seen["torch"] == seen["jax"] == [True, True, False, True]
    assert not t_spans.enabled()
