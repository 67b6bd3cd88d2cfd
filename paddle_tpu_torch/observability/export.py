"""Exporters, the health-provider registry and the crash flight recorder
(counterpart of paddle_tpu/observability/export.py).

- `prometheus_text()` — the Prometheus text exposition format of the
  metrics registry (metric ids have their '.' mapped to '_'; histogram
  buckets carry their OpenMetrics exemplar); `serve_metrics(port)`
  exposes it on a background HTTP endpoint at /metrics, next to
  /healthz (FLAGS_metrics_port; binds loopback unless
  PADDLE_METRICS_HOST says otherwise). `http_get_payload(path)` is the
  one GET surface both that endpoint and the serving gateway answer
  with.
- `write_snapshot(path)` — one JSON file ({ts, metrics, spans})
  committed atomically; `append_jsonl(path, record)` — append-only
  JSONL, flushed per record so a killed process loses at most the line
  in flight.
- the health-provider registry behind /healthz: subsystems register a
  zero-argument provider returning a JSON-serializable dict;
  `health_payload()` merges them.
- the crash FLIGHT RECORDER — `install_flight_recorder(path)` attaches
  an append-only JSONL event log (FLAGS_flight_recorder): every armed
  span begin/end is written through live, and a `dump` record (open
  spans, span-ring tail, metrics snapshot) is appended from an atexit
  hook, a SIGTERM handler (which chains the previous disposition),
  `CommWatchdog` firing, and explicit `flight_dump(reason)` calls.
  `faulthandler` points at the same file, so a fatal-signal traceback
  lands next to the telemetry. A process killed with SIGKILL still
  leaves the write-through lines: the begin line without its end names
  the span it died in.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import re
import threading
import time
from typing import Optional

from . import metrics, spans

__all__ = ["prometheus_text", "serve_metrics", "stop_metrics_server",
           "http_get_payload", "register_health_provider",
           "unregister_health_provider", "health_payload",
           "write_snapshot", "append_jsonl", "install_flight_recorder",
           "uninstall_flight_recorder", "flight_recorder_path",
           "flight_dump"]

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(metric_id: str) -> str:
    return _NAME_SANITIZE.sub("_", metric_id)


def _prom_value(v) -> str:
    """Full-precision sample rendering: %g rounds to 6 significant
    digits, which corrupts any counter past ~1e6 (one 128MB all_reduce
    already overflows byte counters). Integral values print exact;
    floats use repr (shortest round-trip)."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _prom_label_str(label_key: str, extra: Optional[dict] = None) -> str:
    """'op=all_reduce' (registry label-key form) + extras ->
    '{op="all_reduce"}'; empty -> ''. split_label_key resolves the
    registry's escaping, so a ','/'=' inside a label VALUE (worker
    names, section labels) cannot fork into bogus label pairs."""
    parts = list(metrics.split_label_key(label_key))
    for k, v in (extra or {}).items():
        parts.append((k, v))
    if not parts:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in parts)
    return "{%s}" % body


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Prometheus text format of the full registry (instruments +
    collector-bridged counters). Histograms emit cumulative _bucket
    series plus _sum/_count, per Prometheus histogram convention."""
    snap = snap if snap is not None else metrics.snapshot()
    insts = metrics.instruments()
    lines = []

    def _head(metric_id, kind):
        name = _prom_name(metric_id)
        inst = insts.get(metric_id)
        if inst is not None and inst.help:
            lines.append(f"# HELP {name} {inst.help}")
        lines.append(f"# TYPE {name} {kind}")
        return name

    for kind in ("counter", "gauge"):
        for metric_id, series in sorted(snap.get(kind + "s", {}).items()):
            name = _head(metric_id, kind)
            for label_key, value in sorted(series.items()):
                lines.append(f"{name}{_prom_label_str(label_key)} "
                             f"{_prom_value(value)}")
    for metric_id, series in sorted(snap.get("histograms", {}).items()):
        name = _head(metric_id, "histogram")
        for label_key, cell in sorted(series.items()):
            exemplars = cell.get("exemplars") or {}
            cum = 0
            for le, n in cell["buckets"]:
                cum += n
                le_s = "+Inf" if le == "+Inf" else "%g" % le
                line = (f"{name}_bucket"
                        f"{_prom_label_str(label_key, {'le': le_s})} {cum}")
                ex = exemplars.get(le_s)
                if ex:
                    # OpenMetrics exemplar: a p99 bucket names a
                    # concrete trace id to pull via GET /v1/trace/<id>
                    line += (' # {trace_id="%s"} %s %s'
                             % (ex["trace_id"], _prom_value(ex["value"]),
                                _prom_value(ex["ts"])))
                lines.append(line)
            lines.append(
                f"{name}_sum{_prom_label_str(label_key)} "
                f"{_prom_value(cell['sum'])}")
            lines.append(
                f"{name}_count{_prom_label_str(label_key)} "
                f"{cell['count']}")
    return "\n".join(lines) + "\n"


# -- JSON / JSONL ------------------------------------------------------------

def atomic_write(path: str, write) -> None:
    """Commit a file atomically: `write(f)` into a temporary file beside
    `path`, fsync, then os.replace over `path` (a reader sees the old
    file or the whole new one)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_snapshot(path: str, extra: Optional[dict] = None) -> dict:
    """Atomically commit {ts, metrics, spans, **extra} as JSON at `path`.
    Returns the payload."""
    payload = {"ts": time.time(), "metrics": metrics.snapshot(),
               "spans": spans.ring()}
    if extra:
        payload.update(extra)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    blob = json.dumps(payload).encode()
    atomic_write(path, lambda f: f.write(blob))
    return payload


def append_jsonl(path: str, record: dict) -> None:
    """Append one JSON line + flush. Append mode never destroys prior
    bytes (the atomic-write lint's own exemption) and the flush pushes
    the line to the kernel, so it survives the process being killed."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()


# -- HTTP /metrics endpoint --------------------------------------------------

_server = None
_server_thread = None

# -- health/readiness providers: subsystems (the serving engine's
# health_snapshot) register a zero-arg dict provider; the metrics
# endpoint serves the merged view at /healthz next to /metrics.
_health_providers: dict = {}


def register_health_provider(name: str, fn) -> None:
    """Register (or replace) a named zero-arg provider returning a
    JSON-serializable dict for the /healthz payload."""
    _health_providers[name] = fn


def unregister_health_provider(name: str) -> None:
    _health_providers.pop(name, None)


def health_payload() -> dict:
    """The merged /healthz body. A broken provider reports its error
    under its own key instead of failing the whole probe."""
    out = {"ok": True}
    for name, fn in sorted(_health_providers.items()):
        try:
            out[name] = fn()
        except Exception as e:        # readiness must not fail on one bad hook
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            out["ok"] = False
    return out


def http_get_payload(path: str):
    """The shared GET surface over the registry: (status, content_type,
    body bytes) for '/metrics' (or '') and '/healthz', None for unknown
    paths. One implementation worn by the FLAGS_metrics_port endpoint
    AND the serving gateway (inference/gateway.py), so both speak the
    same exposition format and the same readiness semantics (a broken
    health provider reads 503 — probes key on the STATUS code)."""
    path = path.split("?", 1)[0].rstrip("/")
    if path == "/healthz":
        payload = health_payload()
        status = 200 if payload.get("ok", False) else 503
        return (status, "application/json",
                json.dumps(payload, indent=1).encode())
    if path in ("", "/metrics"):
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                prometheus_text().encode())
    return None


def serve_metrics(port: int, host: Optional[str] = None) -> Optional[int]:
    """Start (or move) the background /metrics (+ /healthz) HTTP
    endpoint; port 0 stops it. Returns the bound port. Consumed by
    FLAGS_metrics_port. A port that cannot be bound raises."""
    global _server, _server_thread
    stop_metrics_server()
    if not port:
        return None
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            got = http_get_payload(self.path)
            if got is None:
                self.send_error(404)
                return
            status, ctype, body = got
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):    # no stderr chatter per scrape
            pass

    host = host or os.environ.get("PADDLE_METRICS_HOST", "127.0.0.1")
    _server = ThreadingHTTPServer((host, int(port)), _Handler)
    _server_thread = threading.Thread(target=_server.serve_forever,
                                      daemon=True,
                                      name="paddle-metrics-http")
    _server_thread.start()
    return _server.server_address[1]


def stop_metrics_server() -> None:
    global _server, _server_thread
    if _server is not None:
        try:
            _server.shutdown()
            _server.server_close()
        except Exception:
            pass
    _server = None
    _server_thread = None


# -- crash flight recorder ---------------------------------------------------

def _identity() -> dict:
    """Rank + incarnation stamped on every flight-recorder start/dump
    record, so a post-mortem names which rank's which relaunch died
    without correlating pids against a supervisor's log."""
    out = {}
    rank = os.environ.get("PADDLE_TRAINER_ID")
    if rank is not None:
        out["rank"] = rank
    inc = os.environ.get("PADDLE_INCARNATION")
    if inc is not None:
        out["incarnation"] = inc
    return out


class _FlightRecorder:
    """Append-only JSONL event log with write-through span events and
    on-demand `dump` records. The file handle stays open for the process
    lifetime so faulthandler can target it."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a")
        # RLock: the SIGTERM/atexit dump can interrupt the main thread
        # mid-write of a span event; re-acquiring the write lock on the
        # same thread must not deadlock the dying process
        self._wlock = threading.RLock()
        self._write({"ev": "flight_recorder_start", "ts": time.time(),
                     "pid": os.getpid(), **_identity()})
        spans.add_sink(self._on_span)

    def _on_span(self, ev: dict) -> None:
        self._write(ev)

    def _write(self, obj: dict) -> None:
        try:
            line = json.dumps(obj) + "\n"
        except (TypeError, ValueError):
            return
        with self._wlock:
            try:
                self._fh.write(line)
                self._fh.flush()      # to the kernel: survives SIGKILL
            except (OSError, ValueError, RuntimeError):
                # RuntimeError: "reentrant call inside BufferedWriter" —
                # the SIGTERM/watchdog dump can interrupt the main
                # thread MID-write of a span event; losing that one
                # line must not abort the signal handler (which still
                # has to restore the prior disposition and re-deliver)
                pass

    def dump(self, reason: str) -> None:
        # thread ident -> NAME of every live thread, so a post-mortem
        # reading open_spans (which carry idents) can say "wedged in
        # router-probe", not "wedged in Thread-7"
        threads = {str(t.ident): t.name for t in threading.enumerate()
                   if t.ident is not None}
        self._write({"ev": "dump", "reason": reason, "ts": time.time(),
                     "pid": os.getpid(), **_identity(),
                     "threads": threads,
                     "open_spans": spans.open_spans(),
                     "ring_tail": spans.ring()[-64:],
                     "metrics": metrics.snapshot()})

    def close(self) -> None:
        spans.remove_sink(self._on_span)
        with self._wlock:
            try:
                self._fh.close()
            except OSError:
                pass


_recorder: Optional[_FlightRecorder] = None
_hooks_installed = False
_faulthandler_ours = False
_prev_sigterm = None


def _atexit_dump() -> None:
    if _recorder is not None:
        _recorder.dump("atexit")


def _on_sigterm(signum, frame):
    flight_dump("signal:SIGTERM")
    import signal as _signal
    # restore the PRIOR disposition (signal.signal accepts handler
    # callables and SIG_IGN/SIG_DFL alike), then honor it: a process
    # that had configured SIGTERM ignored (preemption drain) must keep
    # ignoring it — only non-ignoring dispositions get the re-delivery
    # that lets the process die / the prior handler run
    prev = _prev_sigterm
    try:
        _signal.signal(_signal.SIGTERM,
                       prev if prev is not None else _signal.SIG_DFL)
    except (TypeError, ValueError):
        _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
        prev = _signal.SIG_DFL
    if prev == _signal.SIG_IGN:
        return
    os.kill(os.getpid(), signum)


def install_flight_recorder(path: str) -> None:
    """Attach the flight recorder to `path` (FLAGS_flight_recorder).
    Also arms spans+metrics if they are not armed yet — a flight
    recorder with no events would be useless."""
    global _recorder, _hooks_installed, _faulthandler_ours, _prev_sigterm
    if _recorder is not None:
        if os.path.abspath(_recorder.path) == os.path.abspath(path):
            return
        uninstall_flight_recorder()
    _recorder = _FlightRecorder(path)
    if not metrics.enabled():
        metrics.enable(True)
    if not spans.enabled():
        spans.enable(True)
    try:
        if not faulthandler.is_enabled():
            faulthandler.enable(file=_recorder._fh)
            _faulthandler_ours = True
    except Exception:
        pass
    if not _hooks_installed:
        _hooks_installed = True
        atexit.register(_atexit_dump)
        try:
            import signal as _signal
            if threading.current_thread() is threading.main_thread():
                _prev_sigterm = _signal.getsignal(_signal.SIGTERM)
                _signal.signal(_signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass


def uninstall_flight_recorder() -> None:
    global _recorder, _faulthandler_ours
    if _recorder is not None:
        if _faulthandler_ours:
            # faulthandler still points at the file we are about to
            # close — a later fatal signal would hit a dead fd
            try:
                faulthandler.disable()
            except Exception:
                pass
            _faulthandler_ours = False
        _recorder.close()
        _recorder = None


def flight_recorder_path() -> Optional[str]:
    return _recorder.path if _recorder is not None else None


def flight_dump(reason: str) -> None:
    """Append a dump record (open spans + ring tail + metrics snapshot)
    if a recorder is installed; no-op otherwise. Called by
    CommWatchdog when a step overruns."""
    if _recorder is not None:
        _recorder.dump(reason)


def flight_event(record: dict) -> None:
    """Write one record through the installed flight recorder (no-op
    otherwise), for events that must survive SIGKILL the instant they
    happen."""
    if _recorder is not None:
        _recorder._write(record)
