"""Goodput ledger: step-time decomposition into labeled buckets and a
live MFU gauge (counterpart of paddle_tpu/observability/goodput.py).

Model: a training loop's wall time is a sequence of step WINDOWS —
`step_boundary()` is called once per step (jit.TrainStep does this; any
custom loop may too) and closes the window opened by the previous
boundary (or by an explicit `open_window()` at loop start). Inside a
window, instrumented subsystems attribute badput seconds to a category
(`CATEGORIES`); the port feeds `compile` from the kernels' nvcc build
(kernels/_build.py through device_events.note_compile), and `timed_iter`
/ `time_section` / `consumer_wait` are there for a loop's data wait and
stalls. Whatever remains of the window is PRODUCTIVE time:

  productive = max(0, wall - sum(badput))        [category=device_execute]

so the bucket seconds sum to the measured wall time by construction and
roll into `goodput.productive_seconds_total` /
`goodput.badput_seconds_total`. The MFU gauge divides a step's FLOPs,
when the caller passes them, by step seconds * the card's peak FLOP/s
(`peak_flops_per_sec`); the port's TrainStep has no FLOP count to pass,
so the gauge stays unset there.

Disarmed (the registry discipline): `attribute()` / `step_boundary()` are
one module-global bool check.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from . import metrics as _m

__all__ = ["attribute", "time_section", "timed_iter", "consumer_wait",
           "open_window", "step_boundary", "summary", "reset",
           "peak_flops_per_sec", "CATEGORIES"]

CATEGORIES = ("data_wait", "host_pull", "compile", "checkpoint_stall",
              "elastic_barrier", "elastic_recovery", "other")

_C_PRODUCTIVE = _m.counter(
    "goodput.productive_seconds_total",
    "step-window seconds left after badput attribution "
    "(category=device_execute)")
_C_BADPUT = _m.counter(
    "goodput.badput_seconds_total",
    "step-window seconds attributed to a non-productive category")
_C_STEPS = _m.counter("goodput.steps_total",
                      "step windows closed by the ledger")
_G_MFU = _m.gauge(
    "goodput.mfu", "live model FLOPs utilization: step FLOPs / "
    "(step seconds * peak FLOP/s); unset when the FLOPs or the peak are "
    "unknown")
_G_STEP_FLOPS = _m.gauge(
    "goodput.step_flops",
    "FLOPs of the step feeding the MFU gauge")
_G_LAST_STEP = _m.gauge("goodput.last_step_seconds",
                        "wall seconds of the last closed step window")

_lock = threading.RLock()
_t0: Optional[float] = None              # open-window start
_window_attr: Dict[str, float] = {}      # category -> seconds this window
_totals: Dict[str, float] = {}           # category -> seconds since reset
_productive_total = 0.0
_steps = 0
_last_mfu = 0.0

# thread-local guard: while `timed_iter` is timing a consumer-side
# `next()`, a prefetcher's attribution of the same wait (consumer_wait,
# called inside that next() on the same thread) must not double-count
_tl = threading.local()


def attribute(category: str, seconds: float) -> None:
    """Attribute `seconds` of the current step window to a badput
    category. Disarmed: one bool check."""
    if not _m.enabled():
        return
    if seconds <= 0:
        return
    with _lock:
        _window_attr[category] = _window_attr.get(category, 0.0) + seconds


class time_section:
    """`with time_section("checkpoint_stall"): ...` — attribute the block's
    wall time. Disarmed: an object allocation + one bool check."""

    __slots__ = ("category", "_t0")

    def __init__(self, category: str):
        self.category = category

    def __enter__(self):
        self._t0 = time.perf_counter() if _m.enabled() else None
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            attribute(self.category, time.perf_counter() - self._t0)
        return False


def timed_iter(iterable, category: str = "data_wait"):
    """Wrap an iterable so time the consumer spends blocked in `next()`
    is attributed to `category`. Sets the dedup guard so a prefetcher's
    `consumer_wait` does not attribute the same wait twice."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        _tl.timing = True
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            _tl.timing = False
        attribute(category, time.perf_counter() - t0)
        yield item


def consumer_wait(seconds: float) -> None:
    """A prefetcher's seam: attribute a staged-batch queue wait as
    data_wait UNLESS a `timed_iter` on this thread is already timing the
    enclosing next()."""
    if getattr(_tl, "timing", False):
        return
    attribute("data_wait", seconds)


def open_window() -> None:
    """Start (or restart) a step window NOW, discarding attribution that
    accumulated outside any window. Called at loop start so the first
    step's window covers its data wait and compile."""
    global _t0
    if not _m.enabled():
        return
    with _lock:
        _window_attr.clear()
        _t0 = time.perf_counter()


def step_boundary(flops: Optional[float] = None) -> Optional[dict]:
    """Close the current step window and open the next one. Returns the
    window's breakdown {wall, productive, badput: {category: s}} — or
    None when disarmed or no window was open (first boundary just opens
    one). `flops` (the step's FLOP count, when the caller has one)
    drives the MFU gauge."""
    global _t0, _productive_total, _steps, _last_mfu
    if not _m.enabled():
        return None
    now = time.perf_counter()
    with _lock:
        if _t0 is None:
            _window_attr.clear()
            _t0 = now
            return None
        wall = now - _t0
        attrs = dict(_window_attr)
        _window_attr.clear()
        _t0 = now
        badput = sum(attrs.values())
        productive = max(0.0, wall - badput)
        for cat, s in attrs.items():
            _totals[cat] = _totals.get(cat, 0.0) + s
        _productive_total += productive
        _steps += 1
    _C_PRODUCTIVE.inc(productive, category="device_execute")
    for cat, s in attrs.items():
        _C_BADPUT.inc(s, category=cat)
    _C_STEPS.inc()
    _G_LAST_STEP.set(wall)
    mfu = 0.0
    if flops:
        _G_STEP_FLOPS.set(float(flops))
        peak = peak_flops_per_sec()
        if peak and wall > 0:
            mfu = float(flops) / (wall * peak)
            _G_MFU.set(mfu)
            # only a flops-carrying boundary updates the summary's MFU:
            # auxiliary windows (manual boundaries) must not zero the
            # last real reading
            with _lock:
                _last_mfu = mfu
    return {"wall": wall, "productive": productive, "badput": attrs,
            "mfu": mfu}


def summary() -> dict:
    """Cumulative ledger view since reset(): step count, productive and
    per-category badput seconds, the attributed fraction of total window
    wall, and the last MFU reading."""
    with _lock:
        badput = dict(_totals)
        productive = _productive_total
        steps = _steps
        mfu = _last_mfu
    wall = productive + sum(badput.values())
    return {
        "steps": steps,
        "wall_seconds": wall,
        "productive_seconds": productive,
        "badput_seconds": badput,
        "productive_fraction": (productive / wall) if wall else 0.0,
        "mfu": mfu,
    }


def reset() -> None:
    """Drop window state and cumulative totals (registry counters are
    reset separately via metrics.reset())."""
    global _t0, _productive_total, _steps, _last_mfu
    with _lock:
        _t0 = None
        _window_attr.clear()
        _totals.clear()
        _productive_total = 0.0
        _steps = 0
        _last_mfu = 0.0


# dense bf16 tensor-core peak FLOP/s by card name (NVIDIA's data sheet,
# SXM part; the rate PERF.md's bounds use)
_PEAK = {"h100": 989e12}

_peak_cache: Optional[float] = None


def peak_flops_per_sec() -> float:
    """Peak FLOP/s of the local card for the MFU gauge.
    PADDLE_PEAK_FLOPS overrides (tests, unlisted hardware); 0.0 with no
    card or a card not in the table — the gauge then stays unset."""
    global _peak_cache
    env = os.environ.get("PADDLE_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if _peak_cache is not None:
        return _peak_cache
    import torch
    peak = 0.0
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0).lower().replace(" ", "")
        peak = next((p for tag, p in _PEAK.items() if tag in name), 0.0)
    _peak_cache = peak
    return peak
