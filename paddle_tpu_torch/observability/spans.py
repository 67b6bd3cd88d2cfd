"""Span tracing: begin/end/duration records in a bounded in-memory ring,
forwarded to `torch.profiler.record_function` so armed spans show up by
name in a `torch.profiler` trace (counterpart of
paddle_tpu/observability/spans.py, which forwards to
jax.profiler.TraceAnnotation).

Armed/disarmed follows the metrics registry's discipline: a disarmed
`span(...)` is an object allocation + one bool check, nothing else — no
ring append, no profiler range, no sink call. Arm via FLAGS_metrics /
`observability.enable()`.

Every armed span begin/end event also fans out to registered SINKS:
the crash flight recorder (observability/export.py) registers one to
write each event through to an append-only JSONL file, so a process
killed mid-span leaves the begin line of the span it died in.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List

__all__ = ["span", "enable", "enabled", "ring", "clear", "set_ring_size",
           "open_spans", "add_sink", "remove_sink"]

_enabled = False
_DEFAULT_RING = 512

# reentrant: the flight recorder's signal-handler dump reads ring() /
# open_spans() and may interrupt a record call on the same thread
_lock = threading.RLock()
_ring: deque = deque(maxlen=_DEFAULT_RING)
_seq = itertools.count(1)
_open: Dict[int, dict] = {}      # sid -> begin event (all threads)
_sinks: List[Callable] = []


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def set_ring_size(n: int) -> None:
    """Re-bound the ring (keeps the newest events)."""
    global _ring
    n = max(int(n), 1)
    with _lock:
        _ring = deque(_ring, maxlen=n)


def ring() -> list:
    with _lock:
        return list(_ring)


def clear() -> None:
    with _lock:
        _ring.clear()
        _open.clear()


def open_spans() -> list:
    """Begin events of every span currently open in ANY thread — the
    flight recorder dumps this to name what a hung or dying process was
    doing."""
    with _lock:
        return [dict(ev) for ev in _open.values()]


def add_sink(fn: Callable[[dict], None]) -> None:
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn: Callable) -> None:
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


def _emit(ev: dict) -> None:
    with _lock:
        _ring.append(ev)
        sinks = list(_sinks)
    for s in sinks:
        try:
            s(ev)
        except Exception:
            pass        # a broken sink must not break the traced code


class span:
    """Context manager: `with span("watchdog.serving.tick"): ...` records
    a begin/end pair (wall epoch + monotonic duration) into the ring and
    opens a `torch.profiler.record_function` range of the same name.
    Disarmed: one bool check."""

    __slots__ = ("name", "attrs", "_sid", "_p0", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        if not _enabled:
            self._sid = None
            return self
        self._sid = next(_seq)
        self._p0 = time.perf_counter()
        ev = {"ev": "span_begin", "sid": self._sid, "name": self.name,
              "ts": time.time(), "thread": threading.get_ident(),
              "thread_name": threading.current_thread().name}
        if self.attrs:
            ev["attrs"] = {k: str(v) for k, v in self.attrs.items()}
        with _lock:
            _open[self._sid] = ev
        _emit(ev)
        import torch
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sid is None:
            return False
        self._rf.__exit__(exc_type, exc, tb)
        ev = {"ev": "span_end", "sid": self._sid, "name": self.name,
              "ts": time.time(),
              "dur_s": time.perf_counter() - self._p0}
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        with _lock:
            _open.pop(self._sid, None)
        _emit(ev)
        return False
