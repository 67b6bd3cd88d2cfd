"""Deterministic fault injection for robustness testing (counterpart of
paddle_tpu/utils/fault_injection.py, stdlib only; the same schedule
grammar and hit counting).

Named fault points sit on the serving engine's paths and do NOTHING
unless a schedule is armed: the disarmed fast path is one module-global
bool check.

Schedule grammar (the ``FLAGS_fault_inject`` environment variable at
import, ``paddle_tpu_torch.set_flags``, or :func:`configure`): a comma-
or semicolon-separated list of

    <point>:<action>[:<arg>][@N]

where ``@N`` triggers on the N-th *hit* of that point (1-based, default
1) in this process. Actions:

- ``raise[:ExcName]`` — raise :class:`FaultInjected` (or the named
  builtin: ``RuntimeError``, ``ConnectionError``, ``OSError``,
  ``TimeoutError``)
- ``crash[:code]`` — ``os._exit(code)`` (default 137), no cleanup
- ``delay[:seconds]`` — sleep (default 1.0), a hang or a stall
- ``torn_write`` — truncate the file the call site passes to half its
  bytes and continue

The port's points: ``serving.tick`` (top of every scheduler tick,
inside the SLO layer's isolation boundary), ``serving.admit``
(``add_request`` under the SLO layer), ``serving.page_alloc`` (every KV
page-pool allocation), ``serving.prefix_evict`` (each prefix-cache
eviction pass), ``serving.draft`` (each n-gram draft proposal),
``serving.verify_rollback`` (each page rollback after a refuted
draft) and ``serving.http_request`` (the gateway's POST handler and
each streamed frame).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["FaultInjected", "FaultConfigError", "fault_point", "configure",
           "stats", "enabled"]


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise`` fault (default exception type)."""


# exceptions a schedule may name: types whose constructors take a plain
# message
_EXC_TYPES = {
    "FaultInjected": FaultInjected,
    "RuntimeError": RuntimeError,
    "ConnectionError": ConnectionError,
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
}

_CRASH_EXIT_CODE = 137          # SIGKILL's 128 + 9

_lock = threading.Lock()
_enabled = False                 # fast-path guard: read without the lock
_plans: Dict[str, List[dict]] = {}   # point -> [{action, arg, at, fired}]
_hits: Dict[str, int] = {}           # point -> times reached while enabled
_triggered: Dict[str, int] = {}      # point -> times a fault actually fired


class FaultConfigError(ValueError):
    """Malformed FLAGS_fault_inject schedule."""


def _parse_entry(entry: str):
    head, sep, rest = entry.partition(":")
    point = head.strip()
    if not sep or not point or not rest.strip():
        raise FaultConfigError(
            f"fault_inject: expected '<point>:<action>[:<arg>][@N]', "
            f"got {entry!r}")
    rest = rest.strip()
    at = 1
    if "@" in rest:
        rest, _, n = rest.rpartition("@")
        try:
            at = int(n)
        except ValueError:
            raise FaultConfigError(
                f"fault_inject: bad '@N' in {entry!r}") from None
        if at < 1:
            raise FaultConfigError(
                f"fault_inject: @N must be >= 1 in {entry!r}")
    action, _, arg = rest.partition(":")
    action = action.strip()
    arg = arg.strip() or None
    if action not in ("raise", "crash", "delay", "torn_write"):
        raise FaultConfigError(
            f"fault_inject: unknown action {action!r} in {entry!r}")
    if action == "raise" and arg is not None and arg not in _EXC_TYPES:
        raise FaultConfigError(
            f"fault_inject: unknown exception {arg!r} in {entry!r} "
            f"(allowed: {sorted(_EXC_TYPES)})")
    if action == "delay" and arg is not None:
        try:
            float(arg)
        except ValueError:
            raise FaultConfigError(
                f"fault_inject: bad delay seconds in {entry!r}") from None
    if action == "crash" and arg is not None:
        try:
            int(arg)
        except ValueError:
            raise FaultConfigError(
                f"fault_inject: bad crash exit code in {entry!r}") from None
    if action == "torn_write" and arg is not None:
        raise FaultConfigError(
            f"fault_inject: torn_write takes no arg ({entry!r})")
    return point, {"action": action, "arg": arg, "at": at, "fired": False}


def configure(spec: Optional[str]) -> None:
    """(Re)arm the schedule; ``None`` or empty disarms and clears the
    counters."""
    global _enabled
    plans: Dict[str, List[dict]] = {}
    for entry in (spec or "").replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, plan = _parse_entry(entry)
        plans.setdefault(point, []).append(plan)
    with _lock:
        _plans.clear()
        _plans.update(plans)
        _hits.clear()
        _triggered.clear()
        _enabled = bool(plans)


def enabled() -> bool:
    return _enabled


def stats() -> dict:
    """{'enabled': bool, 'points': {name: {'hits': n, 'triggered': m}}}."""
    with _lock:
        names = set(_hits) | set(_triggered) | set(_plans)
        return {"enabled": _enabled,
                "points": {n: {"hits": _hits.get(n, 0),
                               "triggered": _triggered.get(n, 0)}
                           for n in sorted(names)}}


def _torn_write(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 0) if size > 1 else 0)


def fault_point(name: str, file: Optional[str] = None) -> None:
    """Mark an injectable site. No-op (one bool check) unless armed."""
    if not _enabled:
        return
    with _lock:
        _hits[name] = hit = _hits.get(name, 0) + 1
        due = [p for p in _plans.get(name, ())
               if not p["fired"] and p["at"] == hit]
        for p in due:
            p["fired"] = True
        if due:
            _triggered[name] = _triggered.get(name, 0) + len(due)
    for p in due:
        action, arg = p["action"], p["arg"]
        if action == "delay":
            time.sleep(float(arg) if arg is not None else 1.0)
        elif action == "torn_write":
            if file is None:
                raise FaultInjected(
                    f"fault_inject: torn_write armed at {name!r} but the "
                    f"call site passed no file")
            _torn_write(file)
        elif action == "crash":
            sys.stderr.write(
                f"fault_inject: crash at {name!r} (hit {hit})\n")
            sys.stderr.flush()
            os._exit(int(arg) if arg is not None else _CRASH_EXIT_CODE)
        else:   # raise
            exc = _EXC_TYPES[arg] if arg is not None else FaultInjected
            raise exc(f"fault injected at {name!r} (hit {hit})")


# armed from the environment at import (a subprocess inherits the
# schedule); set_flags routes here in-process
configure(os.environ.get("FLAGS_fault_inject"))
