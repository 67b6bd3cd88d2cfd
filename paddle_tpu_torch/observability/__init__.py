"""Runtime telemetry of the port (counterpart of paddle_tpu/observability).

- `metrics` — process-wide counters, gauges and fixed-bucket histograms
  (with exemplars) with labels; disarmed by default (one bool check a
  record call).
- `spans` — `span(name, **attrs)`: bounded in-memory ring +
  `torch.profiler.record_function` forwarding while armed.
- `export` — the Prometheus text (`/metrics`, FLAGS_metrics_port),
  atomic JSON / append-only JSONL writers, the health-provider registry
  behind `/healthz`, and the crash flight recorder
  (FLAGS_flight_recorder).
- `goodput` — the step-window ledger: productive and badput seconds and
  the MFU gauge.
- `device_events` — per-step telemetry keyed by an executable tag: host
  dispatch wall, device seconds from CUDA event pairs, kernel builds.
- `reqtrace` — request-scope event timelines and the exact attribution
  ledger behind `GET /v1/trace/<id>` (FLAGS_request_trace, armed by
  default in the serving engine; FLAGS_request_trace_sink).

Arm metrics and spans with `FLAGS_metrics=1` (the environment at import,
or `paddle_tpu_torch.set_flags`) or `enable()`. Not ported yet: the lock
witness, per-rank snapshot federation and the post-mortem viewer.
"""
from __future__ import annotations

import os
import threading

from . import (device_events, export, goodput, metrics,  # noqa: F401
               reqtrace, spans)
from .export import (append_jsonl, flight_dump,  # noqa: F401
                     install_flight_recorder, prometheus_text,
                     serve_metrics, uninstall_flight_recorder,
                     write_snapshot)
from .metrics import counter, gauge, histogram, snapshot  # noqa: F401
from .spans import span  # noqa: F401

__all__ = ["metrics", "spans", "export", "goodput", "device_events",
           "reqtrace", "enable", "enabled", "arm", "span",
           "counter", "gauge", "histogram", "snapshot", "prometheus_text",
           "write_snapshot", "append_jsonl", "serve_metrics",
           "install_flight_recorder", "uninstall_flight_recorder",
           "flight_dump", "update_device_memory_gauges"]


def enable(on: bool = True) -> None:
    """Arm (or disarm) the metrics registry and span tracing together."""
    metrics.enable(on)
    spans.enable(on)


def enabled() -> bool:
    return metrics.enabled()


_arm_lock = threading.Lock()
_arm_count = 0
_arm_prev = False


def arm():
    """Arm the registry+spans and return an idempotent restore()
    callable. Refcounted: with two overlapping armers, the first
    restore() must not disarm telemetry under the one still active —
    only the last restore standing reverts to the state captured before
    the first arm."""
    global _arm_count, _arm_prev
    with _arm_lock:
        if _arm_count == 0:
            _arm_prev = metrics.enabled()
        if not metrics.enabled():
            enable(True)    # also re-arms after a direct enable(False)
        _arm_count += 1
    done = [False]

    def restore():
        global _arm_count
        with _arm_lock:
            if done[0]:
                return
            done[0] = True
            _arm_count -= 1
            if _arm_count == 0 and not _arm_prev:
                enable(False)

    return restore


_G_MEM_IN_USE = metrics.gauge("device.bytes_in_use",
                              "device memory currently allocated (bytes); "
                              "unlabeled cell = host total, device=... "
                              "cells = per card")
_G_MEM_PEAK = metrics.gauge("device.peak_bytes_in_use",
                            "peak device memory allocated (bytes); "
                            "unlabeled cell = host total, device=... "
                            "cells = per card")


def update_device_memory_gauges():
    """Refresh device.bytes_in_use / device.peak_bytes_in_use from every
    CUDA device's allocator (`torch.cuda.memory_allocated` /
    `max_memory_allocated`): per-device cells (device="cuda:0", ...)
    plus the unlabeled host total. Returns {'bytes_in_use',
    'peak_bytes_in_use', 'per_device'} — or None with no card."""
    import torch
    if not torch.cuda.is_available():
        return None
    total_in = total_peak = 0
    per_device = {}
    for i in range(torch.cuda.device_count()):
        in_use = int(torch.cuda.memory_allocated(i))
        peak = int(torch.cuda.max_memory_allocated(i))
        label = f"cuda:{i}"
        per_device[label] = {"bytes_in_use": in_use,
                             "peak_bytes_in_use": peak}
        _G_MEM_IN_USE.set(in_use, device=label)
        _G_MEM_PEAK.set(peak, device=label)
        total_in += in_use
        total_peak += peak
    _G_MEM_IN_USE.set(total_in)
    _G_MEM_PEAK.set(total_peak)
    return {"bytes_in_use": total_in, "peak_bytes_in_use": total_peak,
            "per_device": per_device}


# armed from the environment at import (a subprocess inherits it), as
# the reference arms them; set_flags routes here in-process. A port that
# cannot be bound or a path that cannot be opened raises here: the
# process asked for telemetry it would not get.
_FALSY_ENV = (None, "", "0", "false", "False", "off", "OFF")
if os.environ.get("FLAGS_metrics") not in _FALSY_ENV:
    enable(True)
if os.environ.get("FLAGS_span_ring_size"):
    spans.set_ring_size(int(os.environ["FLAGS_span_ring_size"]))
if os.environ.get("FLAGS_metrics_port"):
    export.serve_metrics(int(os.environ["FLAGS_metrics_port"]))
if os.environ.get("FLAGS_flight_recorder"):
    install_flight_recorder(os.environ["FLAGS_flight_recorder"])
if os.environ.get("FLAGS_request_trace_sink"):
    reqtrace.set_sink(os.environ["FLAGS_request_trace_sink"])
