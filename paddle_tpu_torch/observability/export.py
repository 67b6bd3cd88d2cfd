"""The health-provider registry behind `/healthz` (the part of
paddle_tpu/observability/export.py the serving SLO layer uses).

Subsystems register a zero-argument provider returning a JSON-
serializable dict; `health_payload()` merges them. The serving engine
registers its SLO-armed engines' snapshots under "serving". The metrics
HTTP endpoint, the Prometheus text dump and the flight recorder are not
ported yet.
"""
from __future__ import annotations

__all__ = ["register_health_provider", "unregister_health_provider",
           "health_payload"]

_health_providers: dict = {}


def register_health_provider(name: str, fn) -> None:
    """Register (or replace) a named zero-arg provider returning a
    JSON-serializable dict for the /healthz payload."""
    _health_providers[name] = fn


def unregister_health_provider(name: str) -> None:
    _health_providers.pop(name, None)


def health_payload() -> dict:
    """The merged /healthz body. A broken provider reports its error
    under its own key (and clears "ok") instead of failing the probe."""
    out = {"ok": True}
    for name, fn in sorted(_health_providers.items()):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            out["ok"] = False
    return out
