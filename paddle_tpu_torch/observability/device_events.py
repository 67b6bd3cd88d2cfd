"""Per-execution device telemetry keyed by a stable executable tag
(counterpart of paddle_tpu/observability/device_events.py).

- `execution(tag, device)` — a context manager the owner of a step wraps
  around each call of it (jit.TrainStep stamps "train_step"; the serving
  engine stamps "serving.prefill", "serving.ragged_step" and
  "serving.decode"). Each exit observes `xla.dispatch_seconds{
  executable=tag}`: the HOST wall of the call, which under CUDA's
  asynchronous launches is the time to enqueue the step, not the time
  the card spends on it.
- `xla.execute_seconds{executable=tag}` is the card's reading. When
  `device` is a CUDA device, `execution` records a
  `torch.cuda.Event(enable_timing=True)` on the device's current stream
  at enter and another at exit, and the pair's elapsed time is observed
  once the end event has completed: at a later `execution` exit or at
  an explicit `flush()`, never by waiting (no `synchronize()`, no
  `elapsed_time` on an event that has not completed), so the telemetry
  adds no host-device sync to a step. The reading is the stream's span
  between the two records: the kernels of the step and the idle gaps
  in which the stream waited for the host to enqueue them — not the
  kernels' busy time. Off a CUDA device the series stays empty rather
  than republishing host wall under a device name; `note_device_execute`
  feeds it from another source (a profiler post-processor).
- `note_traced_collective(op)` — a collective call made inside an open
  execution window. The port runs eagerly, so every execution notes its
  own collectives: the noted ops REPLACE the tag's composition and the
  exit increments `collective.executed_calls_total{op, executable=tag}`
  by it, once per execution.
- `note_compile(seconds)` — the port's only compile, the nvcc build of
  the kernels (kernels/_build.py), observed into `xla.compile_seconds{
  executable=<the tag active at build time>}` and the goodput ledger's
  `compile` bucket. There is no jax.monitoring listener to install.

Disarmed (the registry discipline): every call is one bool check.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from . import goodput as _goodput
from . import metrics as _m

__all__ = ["execution", "tagged", "note_traced_collective",
           "note_device_execute", "note_compile", "flush", "current_tag",
           "tag_composition"]

# wide-range buckets: builds run seconds-to-minutes, steps ms-to-s
_H_COMPILE = _m.histogram(
    "xla.compile_seconds",
    "kernel build durations (nvcc, kernels/_build.py) by the executable "
    "tag active when they ran",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0))
_H_DISPATCH = _m.histogram(
    "xla.dispatch_seconds",
    "HOST-observed wall seconds per call of a tagged step; under CUDA's "
    "asynchronous launches this is the enqueue time, not device time "
    "(that is xla.execute_seconds)")
_H_EXECUTE = _m.histogram(
    "xla.execute_seconds",
    "DEVICE seconds per tagged step: the CUDA stream's span between an "
    "event recorded at the step's start and one at its end (kernels and "
    "the stream's idle gaps); empty off a CUDA device")
_C_COLL_EXEC = _m.counter(
    "collective.executed_calls_total",
    "per-EXECUTION collective counts: the collectives noted in a tagged "
    "step's execution window, once per execution")

_lock = threading.RLock()
# executable tag -> {op: count} noted at its last execution
_tag_ops: Dict[str, Dict[str, int]] = {}
# (tag, start event, end event) whose end has not been seen complete,
# in record order
_pending: List[tuple] = []

_tl = threading.local()          # .stack: [execution frames]


class _Frame:
    __slots__ = ("tag", "t0", "fresh", "start")

    def __init__(self, tag: str):
        self.tag = tag
        self.t0 = time.perf_counter()
        self.fresh: Dict[str, int] = {}
        self.start = None


def current_tag():
    """The innermost open execution tag on this thread, or None."""
    stack = getattr(_tl, "stack", None)
    return stack[-1].tag if stack else None


def tag_composition(tag: str) -> Dict[str, int]:
    """The collective composition noted at `tag`'s last execution."""
    with _lock:
        return dict(_tag_ops.get(tag, {}))


def _push(tag: str) -> _Frame:
    f = _Frame(tag)
    stack = getattr(_tl, "stack", None)
    if stack is None:
        stack = _tl.stack = []
    stack.append(f)
    return f


def _pop(f: _Frame) -> None:
    stack = getattr(_tl, "stack", None)
    if stack and stack[-1] is f:
        stack.pop()


def _cuda_event(device):
    """A timing event recorded on `device`'s current stream."""
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class execution:
    """`with execution("serving.ragged_step", device): step(...)` —
    times the call into xla.dispatch_seconds{executable=tag}, brackets
    it with CUDA timing events when `device` is a CUDA device (module
    docstring), and replays the collectives noted in it. Disarmed: an
    object allocation + one bool check."""

    __slots__ = ("tag", "device", "_frame")

    def __init__(self, tag: str, device=None):
        self.tag = tag
        self.device = device
        self._frame = None

    def __enter__(self):
        if not _m.enabled():
            return self
        self._frame = f = _push(self.tag)
        if self.device is not None and self.device.type == "cuda":
            f.start = _cuda_event(self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        f = self._frame
        if f is None:
            return False
        self._frame = None
        _pop(f)
        if f.start is not None:
            end = _cuda_event(self.device)
            with _lock:
                _pending.append((f.tag, f.start, end))
        _H_DISPATCH.observe(time.perf_counter() - f.t0, executable=f.tag)
        with _lock:
            if f.fresh:
                # the ops this execution noted ARE the composition now:
                # replace, never append
                _tag_ops[f.tag] = dict(f.fresh)
            comp = _tag_ops.get(f.tag)
        if comp and exc_type is None:
            for op, n in comp.items():
                _C_COLL_EXEC.inc(n, op=op, executable=f.tag)
        flush()
        return False


class tagged:
    """Tag-only window: builds and collective notes attribute to `tag`,
    but NO execution is counted (no xla.dispatch_seconds sample, no
    event pair, no composition replay)."""

    __slots__ = ("tag", "_frame")

    def __init__(self, tag: str):
        self.tag = tag
        self._frame = None

    def __enter__(self):
        if not _m.enabled():
            return self
        self._frame = _push(self.tag)
        return self

    def __exit__(self, exc_type, exc, tb):
        f = self._frame
        if f is None:
            return False
        self._frame = None
        _pop(f)
        if f.fresh:
            with _lock:
                _tag_ops[f.tag] = dict(f.fresh)
        return False


def flush() -> int:
    """Observe, in record order, every pending event pair whose end event
    has completed (`Event.query()`, which does not wait); stop at the
    first that has not. Returns the number of pairs still pending."""
    with _lock:
        done = 0
        for tag, start, end in _pending:
            if not end.query():
                break
            _H_EXECUTE.observe(start.elapsed_time(end) / 1e3,
                               executable=tag)
            done += 1
        del _pending[:done]
        return len(_pending)


def note_traced_collective(op: str) -> None:
    """Note a collective call made inside the execution window open on
    this thread. No-op outside a window."""
    if not _m.enabled():
        return
    stack = getattr(_tl, "stack", None)
    if not stack:
        return
    f = stack[-1]
    f.fresh[op] = f.fresh.get(op, 0) + 1


def note_device_execute(tag: str, seconds: float) -> None:
    """Feed a DEVICE-measured duration for `tag` into xla.execute_seconds
    from another source (a profiler trace post-processor)."""
    if not _m.enabled():
        return
    _H_EXECUTE.observe(float(seconds), executable=tag)


def note_compile(seconds: float) -> None:
    """A kernel build of `seconds`: xla.compile_seconds under the tag
    open on this thread ("untagged" outside a window) and the goodput
    ledger's `compile` bucket."""
    if not _m.enabled():
        return
    _H_COMPILE.observe(float(seconds), executable=current_tag() or "untagged")
    _goodput.attribute("compile", float(seconds))
