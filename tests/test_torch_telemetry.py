"""The port's serving telemetry on the CPU: the gateway's trace surface
(`traceparent` / `X-Request-Trace` honoured end to end, an id minted
when absent, `GET /v1/trace/<id>` and its 404, `/metrics` text that
parses and carries `serving_attribution_seconds` with exemplars), the
flight recorder (write-through spans, a firing watchdog's dump naming
the open span, SIGTERM chaining the previous disposition and leaving an
ignored SIGTERM ignored), `device_events` off a card (host dispatch
observed, device execute empty), and the telemetry flags arming and
disarming their subsystems. The gateway's trace document is held to the
reference engine's trace of the same request (events and buckets
charged)."""
import http.client
import json
import os
import re
import socket
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.models import llama as JL
from paddle_tpu.observability import reqtrace as j_rt
from paddle_tpu_torch import jit as t_jit
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.distributed.watchdog import CommWatchdog
from paddle_tpu_torch.framework import core as t_core
from paddle_tpu_torch.inference import gateway as t_gw
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax
from paddle_tpu_torch.observability import device_events, export, goodput
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.observability import reqtrace as t_rt
from paddle_tpu_torch.observability import spans
from tests.test_torch_slo import TINY

from _torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
KNOBS = dict(max_batch=2, max_seq=64, max_chunk_tokens=8)
PROMPT = [3, 5, 7, 11]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(use_recompute=False, **TINY))
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TL.LlamaConfig(**TINY)
    tm = TL.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, cfg, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def reference_trace(models):
    """The reference's armed engine on PROMPT alone: its trace record."""
    jm, _ = models
    eng = JEngine(jm, **KNOBS)
    r = JReq(list(PROMPT), max_new_tokens=5)
    eng.add_request(r)
    while eng.has_work:
        eng.step()
    rec = r.trace.snapshot()
    with j_rt._lock:
        j_rt._store.pop(r.trace_id, None)
    return rec


@pytest.fixture(autouse=True)
def clean():
    """Every telemetry registry of the port is process-wide: start and
    leave each one disarmed, empty and detached."""
    def reset():
        t_obs.enable(False)
        t_metrics.reset()
        spans.clear()
        t_rt.clear()
        t_rt.set_sink(None)
        goodput.reset()
        export.uninstall_flight_recorder()
        export.stop_metrics_server()
    reset()
    saved = {k: t_core._flags[k] for k in (
        "FLAGS_metrics", "FLAGS_metrics_port", "FLAGS_flight_recorder",
        "FLAGS_span_ring_size", "FLAGS_request_trace_sink")}
    yield
    t_core._flags.update(saved)
    spans.set_ring_size(512)
    reset()


# ------------------------------------------------------------ the gateway

@pytest.fixture
def gateway(models):
    _, tm = models
    t_obs.enable(True)
    g = t_gw.ServingGateway(t_gw.EngineRunner(TEngine(tm, device="cpu",
                                                      **KNOBS)),
                            port=0, keepalive_s=2.0)
    port = g.start()
    yield port
    g.drain(timeout=30)
    g.stop()


def _post(port, body, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("POST", "/v1/generate", body=json.dumps(body),
              headers=headers or {})
    r = c.getresponse()
    raw = r.read().decode()
    c.close()
    return r, raw


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("GET", path)
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, dict(r.getheaders()), body


def _sse_terminal(raw):
    terminal = None
    for block in raw.split("\n\n"):
        block = block.strip()
        if block.startswith("event: "):
            name, _, data = block.partition("\n")
            terminal = (name[len("event: "):], json.loads(data[6:]))
    return terminal


def _trace_doc(port, tid):
    """GET /v1/trace/<tid> once the tick thread has settled it."""
    t0 = time.monotonic()
    while True:
        status, _, body = _get(port, f"/v1/trace/{tid}")
        assert status == 200, body
        doc = json.loads(body)
        if doc["terminal"] or time.monotonic() - t0 > 30:
            return doc
        time.sleep(0.01)


@pytest.mark.parametrize("header", ["X-Request-Trace", "traceparent"])
def test_incoming_trace_id_honoured_end_to_end(gateway, reference_trace,
                                               header):
    tid = "c0ffee00" * 4
    r, raw = _post(gateway, {"prompt": PROMPT, "max_new_tokens": 5},
                   {header: f"00-{tid}-00f067aa0ba902b7-01"})
    assert r.status == 200 and r.getheader("X-Request-Id") == tid
    name, payload = _sse_terminal(raw)
    assert name == "end" and payload["trace_id"] == tid
    doc = _trace_doc(gateway, tid)
    assert doc["trace_id"] == tid and doc["status"] == "served"
    assert sum(doc["buckets"].values()) == pytest.approx(doc["wall"],
                                                         abs=TOL)
    # the engine's part of the trace is the reference engine's; the
    # gateway adds its stream_write charge and event
    ref = reference_trace
    names = [e["ev"] for e in doc["events"]]
    assert [n for n in names if n != "stream_write"] == \
        [e["ev"] for e in ref["events"]]
    assert names.count("stream_write") == 1
    assert doc["decode_ticks"] == ref["decode_ticks"]
    assert set(doc["buckets"]) - {"stream_write"} == set(ref["buckets"])
    assert "stream_write" in doc["buckets"]


def test_minted_id_unknown_404_and_json_answer(gateway):
    r, raw = _post(gateway, {"prompt": [2, 4], "max_new_tokens": 2})
    tid = r.getheader("X-Request-Id")
    assert tid and len(tid) == 32 and t_rt.parse_trace_header(tid) == tid
    assert _sse_terminal(raw)[1]["trace_id"] == tid
    assert _trace_doc(gateway, tid)["status"] == "served"
    status, _, body = _get(gateway, "/v1/trace/" + "0" * 32)
    assert status == 404 and b"unknown trace" in body
    r, raw = _post(gateway, {"prompt": [2, 4], "max_new_tokens": 2,
                             "stream": False})
    doc = json.loads(raw)
    assert r.status == 200 and doc["trace_id"] == r.getheader("X-Request-Id")
    assert t_rt.lookup(doc["trace_id"]) is not None


_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|'
    r'\\.)*",?)*\})? (-?[0-9.e+-]+|\+Inf|NaN)'
    r'( # \{trace_id="[0-9a-f]+"\} [0-9.e+-]+ [0-9.e+-]+)?$')


def test_metrics_text_parses_and_carries_attribution(gateway):
    r, _ = _post(gateway, {"prompt": PROMPT, "max_new_tokens": 4})
    tid = r.getheader("X-Request-Id")
    _trace_doc(gateway, tid)
    status, headers, body = _get(gateway, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    samples = {}
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ", line)
            continue
        m = _SAMPLE.match(line)
        assert m, line
        samples.setdefault(m.group(1), []).append(line)
    attr = samples["serving_attribution_seconds_bucket"]
    assert any(f'trace_id="{tid}"' in ln for ln in attr)
    assert any('bucket="decode_compute"' in ln for ln in attr)
    assert samples["serving_attribution_seconds_count"]
    steps = [ln for ln in samples["xla_dispatch_seconds_count"]
             if 'executable="serving.ragged_step"' in ln]
    assert steps and int(steps[0].split()[-1]) > 0
    assert "xla_execute_seconds_count" not in samples      # no card


# ------------------------------------------------------ the flight recorder

def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def test_flight_recorder_writes_spans_through(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    export.install_flight_recorder(path)
    assert t_metrics.enabled() and spans.enabled()
    assert export.flight_recorder_path() == path
    with spans.span("ckpt.save", path="x"):
        mid = _records(path)
        assert mid[-1]["ev"] == "span_begin" and mid[-1]["name"] == \
            "ckpt.save"
        assert [s["name"] for s in spans.open_spans()] == ["ckpt.save"]
    recs = _records(path)
    assert [r["ev"] for r in recs] == ["flight_recorder_start",
                                       "span_begin", "span_end"]
    assert recs[-1]["dur_s"] >= 0 and spans.open_spans() == []
    export.flight_dump("manual")
    dump = _records(path)[-1]
    assert dump["ev"] == "dump" and dump["reason"] == "manual"
    assert [e["ev"] for e in dump["ring_tail"]] == ["span_begin", "span_end"]
    assert "counters" in dump["metrics"]
    export.flight_event({"ev": "note", "x": 1})
    assert _records(path)[-1] == {"ev": "note", "x": 1}


def test_firing_watchdog_dumps_the_open_span(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    export.install_flight_recorder(path)
    wd = CommWatchdog(timeout=0.05)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with wd.section("serving.tick"):
                t0 = time.monotonic()
                while wd.timeouts == 0 and time.monotonic() - t0 < 10:
                    time.sleep(0.01)
    finally:
        wd.shutdown()
    assert wd.timeouts == 1
    dumps = [r for r in _records(path) if r["ev"] == "dump"]
    assert len(dumps) == 1
    assert dumps[0]["reason"].startswith("watchdog:serving.tick after ")
    assert [s["name"] for s in dumps[0]["open_spans"]] == \
        ["watchdog.serving.tick"]
    assert dumps[0]["metrics"]["counters"]["watchdog.timeouts_total"] == \
        {"section=serving.tick": 1}


_SIGTERM = r"""
import os, signal, sys, time
from paddle_tpu_torch.observability import export
hit = []
if sys.argv[2] == "ignored":
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
else:
    signal.signal(signal.SIGTERM, lambda s, f: hit.append(s))
export.install_flight_recorder(sys.argv[1])
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(0.2)
print("alive", hit == [signal.SIGTERM],
      signal.getsignal(signal.SIGTERM) == signal.SIG_IGN, flush=True)
"""


@pytest.mark.parametrize("prior", ["handler", "ignored"])
def test_sigterm_dumps_and_chains(tmp_path, prior):
    """SIGTERM writes a dump, then restores and honours the previous
    disposition: a Python handler runs, an ignored SIGTERM stays
    ignored (the process lives on either way here)."""
    path = str(tmp_path / "flight.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _SIGTERM, path, prior],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    chained, ignored = prior == "handler", prior == "ignored"
    assert res.stdout.split() == ["alive", str(chained), str(ignored)]
    dumps = [r for r in _records(path) if r["ev"] == "dump"]
    assert [d["reason"] for d in dumps][0] == "signal:SIGTERM"


# ------------------------------------------------------ device events

def test_device_events_off_a_card(models):
    """On the CPU a tagged step observes its host dispatch wall; the
    device series stays empty, with no pending event pair. TrainStep
    closes one goodput window a step; a build and a collective note
    attribute to the open tag."""
    _, tm = models
    t_obs.enable(True)
    with device_events.execution("serving.decode", torch.device("cpu")):
        assert device_events.current_tag() == "serving.decode"
        device_events.note_traced_collective("all_reduce")
        device_events.note_compile(0.25)
    assert device_events.current_tag() is None
    assert device_events.flush() == 0
    assert device_events.tag_composition("serving.decode") == \
        {"all_reduce": 1}
    m = TL.LlamaForCausalLM(TL.LlamaConfig(**TINY), device="cpu")
    step = t_jit.TrainStep(m, t_opt.AdamW(parameters=m.parameters()), m.loss)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        1, 128, (2, 16)).astype(np.int64))
    for _ in range(3):
        step(ids, ids)
    snap = t_metrics.snapshot()
    disp = snap["histograms"]["xla.dispatch_seconds"]
    assert disp["executable=serving.decode"]["count"] == 1
    assert disp["executable=train_step"]["count"] == 3
    assert snap["histograms"]["xla.execute_seconds"] == {}
    assert snap["histograms"]["xla.compile_seconds"][
        "executable=serving.decode"]["sum"] == 0.25
    assert snap["counters"]["collective.executed_calls_total"] == \
        {"executable=serving.decode,op=all_reduce": 1}
    summ = goodput.summary()
    assert summ["steps"] == 2                   # the first boundary opens
    assert summ["mfu"] == 0.0
    assert "goodput.mfu" not in {k for k, v in snap["gauges"].items() if v}
    t_obs.enable(False)
    with device_events.execution("serving.decode", torch.device("cpu")):
        assert device_events.current_tag() is None


# --------------------------------------------------------------- the flags

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_flag_serves_and_stops():
    port = _free_port()
    set_flags({"FLAGS_metrics": True, "FLAGS_metrics_port": port})
    assert t_metrics.enabled() and spans.enabled()
    status, headers, body = _get(port, "/metrics")
    assert status == 200 and b"# TYPE serving_attribution_seconds" in body
    status, _, body = _get(port, "/healthz")
    assert status == 200 and json.loads(body)["ok"] is True
    set_flags({"FLAGS_metrics_port": 0, "FLAGS_metrics": False})
    assert not t_metrics.enabled() and not spans.enabled()
    with pytest.raises(OSError):
        _get(port, "/metrics")


def test_metrics_port_that_cannot_bind_raises():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        with pytest.raises(OSError):
            set_flags({"FLAGS_metrics_port": s.getsockname()[1]})


def test_recorder_ring_and_sink_flags(tmp_path):
    flight = str(tmp_path / "f.jsonl")
    sink = str(tmp_path / "t.jsonl")
    set_flags({"FLAGS_flight_recorder": flight, "FLAGS_span_ring_size": 2,
               "FLAGS_request_trace_sink": sink})
    assert export.flight_recorder_path() == flight and spans.enabled()
    for i in range(3):
        with spans.span(f"s{i}"):
            pass
    assert [e["name"] for e in spans.ring()] == ["s2", "s2"]
    tr = t_rt.new_trace("ab" * 16, now=1.0)
    tr.event("arrival", prompt_tokens=1)
    assert t_rt.sink_path() == sink and _records(sink)[0]["ev"] == "arrival"
    set_flags({"FLAGS_flight_recorder": "", "FLAGS_request_trace_sink": ""})
    assert export.flight_recorder_path() is None and t_rt.sink_path() is None


def test_env_flags_arm_at_import(tmp_path):
    """FLAGS_metrics, FLAGS_flight_recorder and FLAGS_request_trace_sink
    in the environment arm their subsystems when observability is
    imported."""
    flight = str(tmp_path / "f.jsonl")
    sink = str(tmp_path / "t.jsonl")
    code = ("from paddle_tpu_torch import observability as o\n"
            "from paddle_tpu_torch.observability import export, reqtrace\n"
            "print(o.enabled(), export.flight_recorder_path(),"
            " reqtrace.sink_path())\n")
    env = dict(os.environ, PYTHONPATH=REPO, FLAGS_metrics="1",
               FLAGS_flight_recorder=flight, FLAGS_request_trace_sink=sink)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", flight, sink]
    assert _records(flight)[0]["ev"] == "flight_recorder_start"


def test_armed_span_is_a_profiler_range():
    """An armed span opens a torch.profiler range of its name; a
    disarmed one records nothing anywhere."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("serving.quiet"):
            torch.ones(2) + 1
        t_obs.enable(True)
        with spans.span("serving.loud", k=1):
            torch.ones(2) + 1
    names = {e.name for e in prof.events()}
    assert "serving.loud" in names and "serving.quiet" not in names
    assert [e["name"] for e in spans.ring()] == ["serving.loud"] * 2
    assert spans.ring()[0]["attrs"] == {"k": "1"}


def test_tagged_window_counts_no_execution():
    t_obs.enable(True)
    with device_events.tagged("train_step"):
        assert device_events.current_tag() == "train_step"
        device_events.note_traced_collective("all_gather")
        device_events.note_compile(1.5)
    snap = t_metrics.snapshot()
    assert snap["histograms"]["xla.dispatch_seconds"] == {}
    assert device_events.tag_composition("train_step") == {"all_gather": 1}
    assert goodput.step_boundary() is None          # opens a window
    goodput.attribute("compile", 0.5)
    assert goodput.step_boundary()["badput"] == {"compile": 0.5}


def test_snapshot_jsonl_and_memory_gauges(tmp_path):
    t_obs.enable(True)
    t_metrics.counter("serving.sheds_total").inc(2)
    with spans.span("ckpt.save"):
        pass
    path = str(tmp_path / "snap" / "m.json")
    payload = export.write_snapshot(path, extra={"step": 3})
    with open(path) as f:
        assert json.load(f) == payload
    assert payload["metrics"]["counters"]["serving.sheds_total"] == {"": 2}
    assert [e["ev"] for e in payload["spans"]] == ["span_begin", "span_end"]
    assert payload["step"] == 3 and not os.listdir(tmp_path / "snap")[1:]
    log = str(tmp_path / "log" / "a.jsonl")
    export.append_jsonl(log, {"a": 1})
    export.append_jsonl(log, {"b": [2]})
    assert _records(log) == [{"a": 1}, {"b": [2]}]
    if not torch.cuda.is_available():
        assert t_obs.update_device_memory_gauges() is None


def test_sync_calls_count_the_waiting_runtime_calls():
    """testing.sync_calls counts the runtime calls that wait for the card
    and no other: the telemetry's event record, query and elapsed-time
    read are not among them."""
    from types import SimpleNamespace

    from paddle_tpu_torch import testing
    names = ["cudaStreamSynchronize", "cudaMemcpyAsync", "cudaEventRecord",
             "cudaEventQuery", "cudaEventElapsedTime", "cudaLaunchKernel",
             "cudaDeviceSynchronize", "cudaMemcpy", "cudaStreamSynchronize"]
    assert testing.sync_calls([SimpleNamespace(name=n) for n in names]) == 4
    t_obs.enable(True)
    tap = testing.ObservationTap(device_events._H_EXECUTE)
    tap.observe(0.5, executable="serving.decode")
    assert tap.seen == [("serving.decode", 0.5)]
    assert t_metrics.snapshot()["histograms"]["xla.execute_seconds"][
        "executable=serving.decode"]["count"] == 1
