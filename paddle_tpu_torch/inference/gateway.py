"""Streaming HTTP serving front-end over the continuous-batching engine
(counterpart of paddle_tpu/inference/gateway.py; stdlib
ThreadingHTTPServer, no framework dependencies).

* `POST /v1/generate` — JSON body: `prompt` token ids,
  `max_new_tokens`, `eos_token_id`, `priority`, `deadline_s`, `stream`.
  `stream` (default true) answers Server-Sent Events over a
  close-delimited HTTP/1.0 body: one `data: {"tokens": [...]}` frame
  per engine tick carrying every token that tick produced for the
  request, then a terminal `event: end` (served) or `event: error`
  (failed / cancelled) frame. `stream: false` answers one JSON document.
* `GET /healthz` — the engine's health snapshot; 200 while accepting,
  503 + Retry-After while draining or after an engine fault.
* A mid-stream client disconnect cancels the request in the engine
  (slot + pages reclaimed). Graceful drain: stop accepting, finish
  in-flight streams, then stop.

Saved weights are the port's own: `<prefix>.pt` holding
`torch.save(state_dict)` plus the reference's `<prefix>.config.json`
sidecar (the reference's `.pdparams` pickle names paddle_tpu classes and
cannot load without that package). Not ported yet: `/metrics`,
`/v1/trace`, `/v1/infer` and the 429 queue bound (SLO layer).

Threading: ONE tick thread owns the engine loop (`EngineRunner`) and
selects the engine's CUDA device before its first step; HTTP handler
threads reach it only through the runner lock (submit/cancel) and per-
request event queues (token delivery).
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Optional

import torch

from .router import _retry_after_header
from .serving import ContinuousBatchingEngine, GenerationRequest

__all__ = ["EngineRunner", "ServingGateway", "resolve_config",
           "save_for_serving", "load_generation_model", "build_engine"]


# ---------------- model-loading glue ---------------------------------------

def resolve_config(spec):
    """LlamaConfig from a preset name ('llama_tiny'), a JSON file path,
    a dict of LlamaConfig fields, or an existing LlamaConfig. None
    passes through (the caller falls back to the artifact sidecar)."""
    from ..models import llama as L
    if spec is None or isinstance(spec, L.LlamaConfig):
        return spec
    if isinstance(spec, dict):
        return L.LlamaConfig(**spec)
    if isinstance(spec, str):
        if spec.endswith(".json") or os.path.exists(spec):
            with open(spec) as f:
                return L.LlamaConfig(**json.load(f))
        factory = getattr(L, spec, None)
        if callable(factory):
            return factory()
        raise ValueError(
            f"config {spec!r} is neither a JSON file nor a preset "
            f"(llama_tiny / llama_350m / llama_1b / llama_7b)")
    raise TypeError(f"unsupported config spec: {type(spec).__name__}")


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_for_serving(model, path_prefix: str) -> None:
    """Persist a causal LM the gateway can reload: `<prefix>.pt`
    (torch.save of the state dict, on the CPU) + `<prefix>.config.json`."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    _atomic_write(path_prefix + ".pt", lambda f: torch.save(state, f))
    blob = json.dumps(dataclasses.asdict(model.cfg), indent=1).encode()
    _atomic_write(path_prefix + ".config.json", lambda f: f.write(blob))


def load_generation_model(path_prefix: str, config=None, device=None):
    """Rebuild a LlamaForCausalLM on `device` from `<prefix>.pt`, with
    the config from `config` (preset / JSON path / dict) or the
    `<prefix>.config.json` sidecar."""
    from ..models import llama as L
    cfg = resolve_config(config)
    if cfg is None:
        sidecar = path_prefix + ".config.json"
        if not os.path.exists(sidecar):
            raise FileNotFoundError(
                f"no config given and no sidecar at {sidecar} — pass "
                f"config= (preset/JSON) or export with save_for_serving")
        with open(sidecar) as f:
            cfg = L.LlamaConfig(**json.load(f))
    model = L.LlamaForCausalLM(cfg, device=device)
    state = torch.load(path_prefix + ".pt", map_location=model.device,
                       weights_only=True)
    model.load_state_dict(state)
    return model


def build_engine(model, **knobs) -> ContinuousBatchingEngine:
    """ContinuousBatchingEngine with the serving front-end's knobs."""
    return ContinuousBatchingEngine(model, **knobs)


# ---------------- engine runner --------------------------------------------

class _TokenStream:
    """Per-request event funnel from the tick thread to one handler
    thread: ('tokens', [ids...]) frames, one per tick, then one
    ('end', status, error)."""

    def __init__(self, req: GenerationRequest):
        self.req = req
        self.q: queue.Queue = queue.Queue()
        self.sent = 0


class EngineRunner:
    """Owns the engine tick loop on a dedicated thread. Handler threads
    never wait for a tick: submit and cancel append to an inbox that the
    tick thread applies between steps (a handler that had to take the
    engine lock could lose the race for it to the tick thread tick after
    tick, delaying admission by many steps)."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 idle_wait_s: float = 0.02):
        self.engine = engine
        self.lock = threading.RLock()       # the engine: tick thread, health
        self.idle_wait_s = float(idle_wait_s)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._streams: dict = {}            # request_id -> _TokenStream
        self._inbox: list = []              # ("submit", stream) | ("cancel", req, reason)
        self._inbox_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.draining = False
        self.fatal: Optional[BaseException] = None

    def start(self) -> "EngineRunner":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="engine-tick", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting and wait for in-flight work to finish. True
        when the engine went idle in time; False on timeout or after an
        engine fault."""
        self.draining = True
        t0 = time.monotonic()
        while True:
            with self.lock:
                if self.fatal is not None:
                    return False
                busy = self.engine.has_work
            with self._inbox_lock:
                busy = busy or bool(self._inbox)
            if not busy:
                return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.01)

    def submit(self, req: GenerationRequest) -> _TokenStream:
        """Queue one request for the next tick and return its token
        stream. An impossible prompt raises ValueError here; a failed
        engine raises RuntimeError."""
        self.engine.check_request(req)
        st = _TokenStream(req)
        with self._inbox_lock:
            if self.fatal is not None:
                raise RuntimeError(
                    f"engine failed: {type(self.fatal).__name__}: "
                    f"{self.fatal}")
            self._inbox.append(("submit", st))
        self._wake.set()
        return st

    def cancel(self, req: GenerationRequest,
               reason: str = "client disconnected") -> None:
        with self._inbox_lock:
            self._inbox.append(("cancel", req, reason))
        self._wake.set()

    def health(self) -> dict:
        with self.lock:
            snap = self.engine.health_snapshot()
        snap["draining"] = self.draining
        if self.fatal is not None:
            snap["ready"] = False
            snap["fatal"] = f"{type(self.fatal).__name__}: {self.fatal}"
        if self.draining or self.fatal is not None:
            snap["accepting"] = False
            snap.setdefault("retry_after_s", 1.0)
        return snap

    @property
    def accepting(self) -> bool:
        return self.fatal is None and not self.draining

    def _apply_inbox(self) -> None:
        """Tick thread, holding the lock: admit queued submits and apply
        queued cancels, in arrival order."""
        with self._inbox_lock:
            ops, self._inbox = self._inbox, []
        for op in ops:
            if op[0] == "submit":
                st = op[1]
                self.engine.add_request(st.req)
                self._streams[st.req.request_id] = st
            else:
                _, req, reason = op
                self._streams.pop(req.request_id, None)
                self.engine.cancel_request(req, reason=reason)

    def _fail(self, exc: BaseException) -> None:
        """Engine-level fault: fail every open or queued stream loudly
        and flip /healthz unready. Caller holds the lock."""
        with self._inbox_lock:
            self.fatal = exc
            ops, self._inbox = self._inbox, []
        streams = list(self._streams.values()) + [
            op[1] for op in ops if op[0] == "submit"]
        for st in streams:
            st.q.put(("end", "failed", f"engine fault: {exc}"))
        self._streams.clear()

    def _loop(self):
        if self.engine.device.type == "cuda":
            # a new thread starts on the process's first device: select
            # the engine's card before the first step
            try:
                torch.cuda.set_device(self.engine.device)
            except Exception as exc:
                with self.lock:
                    self._fail(exc)
                return
        while not self._stop.is_set():
            with self.lock:
                try:
                    self._apply_inbox()
                    busy = self.engine.has_work
                    if busy:
                        self.engine.step()
                except Exception as exc:
                    self._fail(exc)
                    return
                if busy:
                    self._dispatch()
            if not busy:
                self._wake.wait(self.idle_wait_s)
                self._wake.clear()

    def _dispatch(self):
        """Push each open stream this tick's new tokens (one event per
        request per tick) and its terminal status; consume the engine's
        finished list."""
        done = []
        for rid, st in self._streams.items():
            out = st.req.output
            if st.sent < len(out):
                st.q.put(("tokens", list(out[st.sent:])))
                st.sent = len(out)
            if st.req.done:
                st.q.put(("end", st.req.status, st.req.error))
                done.append(rid)
        for rid in done:
            self._streams.pop(rid, None)
        self.engine.finished.clear()


# ---------------- the HTTP gateway -----------------------------------------

_STATUS_HTTP = {"served": 200, "failed": 500, "cancelled": 500}


class ServingGateway:
    """stdlib ThreadingHTTPServer front-end over an EngineRunner."""

    def __init__(self, runner: EngineRunner, host: str = "127.0.0.1",
                 port: int = 0, keepalive_s: float = 0.5):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.runner = runner
        self.keepalive_s = float(keepalive_s)
        self.draining = False
        gw = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):
                pass

            def do_GET(self):
                gw._handle_get(self)

            def do_POST(self):
                gw._handle_post(self)

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self.runner.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="gateway-http",
                daemon=True)
            self._thread.start()
        return self.port

    def drain(self, timeout: Optional[float] = None) -> bool:
        self.draining = True
        return self.runner.drain(timeout)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.runner.stop()

    @property
    def accepting(self) -> bool:
        return not self.draining and self.runner.accepting

    def _health(self) -> dict:
        return {"accepting": self.accepting, "draining": self.draining,
                "port": self.port, "engine": self.runner.health()}

    def _handle_get(self, h):
        path = h.path.split("?", 1)[0].rstrip("/")
        if path == "/healthz":
            body = self._health()
            status = 200 if body["accepting"] else 503
            extra = {}
            if status != 200:
                extra["Retry-After"] = _retry_after_header(
                    body["engine"].get("retry_after_s", 1.0))
            self._json(h, status, body, extra)
            return
        self._json(h, 404, {"error": f"no route for {h.path!r}"})

    def _handle_post(self, h):
        path = h.path.split("?", 1)[0].rstrip("/")
        try:
            n = int(h.headers.get("Content-Length") or 0)
            try:
                spec = json.loads(h.rfile.read(n) or b"{}")
            except ValueError:
                self._json(h, 400, {"error": "body is not valid JSON"})
                return
            if path == "/v1/generate":
                self._generate(h, spec)
            else:
                self._json(h, 404, {"error": f"no route for {h.path!r}"})
        except (BrokenPipeError, ConnectionResetError):
            pass                        # client left before the answer
        except Exception as exc:        # one request fails, not the server
            try:
                self._json(h, 500, {"error": f"{type(exc).__name__}: {exc}"})
            except OSError:
                pass

    def _generate(self, h, spec):
        if not self.accepting:
            self._json(h, 503, {"error": "gateway is draining"},
                       {"Retry-After": "1"})
            return
        prompt = spec.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            self._json(h, 400, {"error": "prompt must be a non-empty "
                                "list of token ids"})
            return
        try:
            max_new = int(spec.get("max_new_tokens", 32))
            priority = int(spec.get("priority", 0))
            eos = spec.get("eos_token_id")
            eos = None if eos is None else int(eos)
            deadline = spec.get("deadline_s")
            deadline = None if deadline is None else float(deadline)
            if max_new < 1:
                raise ValueError("max_new_tokens must be >= 1")
        except (TypeError, ValueError) as e:
            self._json(h, 400, {"error": "bad max_new_tokens/priority/"
                                f"eos_token_id/deadline_s: {e}"})
            return
        req = GenerationRequest(prompt=[int(t) for t in prompt],
                                max_new_tokens=max_new, eos_token_id=eos,
                                priority=priority, deadline_s=deadline)
        try:
            stream = self.runner.submit(req)
        except ValueError as e:         # oversized prompt, rejected at submit
            self._json(h, 400, {"error": str(e)})
            return
        except RuntimeError as e:       # engine went fatal
            self._json(h, 503, {"error": str(e)}, {"Retry-After": "1"})
            return
        if spec.get("stream", True):
            self._stream_sse(h, req, stream)
        else:
            self._collect(h, req, stream)

    def _stream_sse(self, h, req, stream):
        """SSE over a close-delimited body: one tokens frame per tick,
        keepalive comments while waiting (they double as the disconnect
        probe), one terminal end/error frame."""
        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.send_header("Connection", "close")
            h.end_headers()
            while True:
                try:
                    ev = stream.q.get(timeout=self.keepalive_s)
                except queue.Empty:
                    h.wfile.write(b": keepalive\n\n")
                    h.wfile.flush()
                    continue
                if ev[0] == "tokens":
                    h.wfile.write(b"data: " + json.dumps(
                        {"tokens": ev[1]}).encode() + b"\n\n")
                    h.wfile.flush()
                    continue
                _, status, error = ev
                payload = {"status": status, "n_tokens": len(req.output)}
                name = b"end"
                if status != "served":
                    payload["error"] = error
                    name = b"error"
                h.wfile.write(b"event: " + name + b"\ndata: "
                              + json.dumps(payload).encode() + b"\n\n")
                h.wfile.flush()
                break
        except OSError:                 # client closed mid-stream
            self.runner.cancel(req)

    def _collect(self, h, req, stream):
        """stream:false — block until terminal, answer one document."""
        while True:
            ev = stream.q.get()
            if ev[0] == "end":
                _, status, error = ev
                break
        body = {"status": status, "output": list(req.output)}
        if error:
            body["error"] = error
        self._json(h, _STATUS_HTTP.get(status, 500), body)

    def _json(self, h, status, obj, extra_headers=None):
        body = json.dumps(obj).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(body)
