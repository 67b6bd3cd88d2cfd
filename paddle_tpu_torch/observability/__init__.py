"""Runtime telemetry of the port (counterpart of paddle_tpu/observability;
the metrics registry and the health-provider registry so far).

- `metrics` — process-wide counters, gauges and fixed-bucket histograms
  with labels; disarmed by default (one bool check a record call).
- `export` — the health-provider registry merged at `/healthz`.

Arm the registry with `FLAGS_metrics=1` (the environment at import, or
`paddle_tpu_torch.set_flags`) or `enable()`. Spans, request traces, the
goodput ledger, device events, `/metrics` and the flight recorder are
not ported yet.
"""
from __future__ import annotations

import os

from . import export, metrics  # noqa: F401
from .metrics import counter, gauge, histogram, snapshot  # noqa: F401

__all__ = ["metrics", "export", "enable", "enabled", "counter", "gauge",
           "histogram", "snapshot"]


def enable(on: bool = True) -> None:
    """Arm (or disarm) the metrics registry."""
    metrics.enable(on)


def enabled() -> bool:
    return metrics.enabled()


# armed from the environment at import (a subprocess inherits it);
# set_flags routes here in-process
if os.environ.get("FLAGS_metrics") not in (None, "", "0", "false",
                                           "False", "off", "OFF"):
    enable(True)
