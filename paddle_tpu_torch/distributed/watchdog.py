"""Section watchdog (counterpart of paddle_tpu/distributed/watchdog.py's
`CommWatchdog`, stdlib only).

A daemon monitor thread times named critical sections and fires when
one overruns its timeout: it counts the overrun (`timeouts`, and the
`watchdog.timeouts_total` counter labelled by section) and warns with a
RuntimeWarning naming the section, once per section entry; the section
itself runs on. A firing watchdog appends a flight-recorder dump
naming the section (`observability.export.flight_dump`, a no-op unless
FLAGS_flight_recorder installed one), and each section is an armed span
("watchdog.<name>"), so the dump lists it among the open spans. The
serving engine keeps a private instance per engine for its ticks
(`tick_timeout_s`).

Not ported yet: `on_timeout="abort"` and the fire hooks, the elastic
master's suspect-peer query, `wrap` and the process-wide `watch()`
singleton (ROADMAP Queue 1 items 9 and 12).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Optional

from ..framework import core
from ..observability import metrics as _m
from ..observability.export import flight_dump
from ..observability.spans import span as _span

__all__ = ["CommWatchdog"]

_WD_TIMEOUTS = _m.counter("watchdog.timeouts_total",
                          "watchdog sections that overran their timeout")


class CommWatchdog:
    """Times named critical sections; warns on overrun.

    timeout: seconds (None: FLAGS_comm_timeout, 1800). on_timeout: "warn",
    the only mode ported."""

    def __init__(self, timeout: Optional[float] = None,
                 on_timeout: str = "warn"):
        if on_timeout != "warn":
            raise NotImplementedError(
                f"CommWatchdog(on_timeout={on_timeout!r}) is not ported "
                f"yet (only 'warn')")
        self.timeout = (float(timeout) if timeout is not None
                        else float(core.get_flag("FLAGS_comm_timeout",
                                                 1800.0)))
        self._lock = threading.Lock()
        self._active = {}          # (name, token) -> start time
        self._fired = set()
        self._token = 0
        self._stop = threading.Event()
        self._thread = None
        self.timeouts = 0

    def _ensure_monitor(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="paddle-watchdog")
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(min(self.timeout / 10.0, 5.0)):
            now = time.monotonic()
            with self._lock:
                overdue = [(key, now - t0)
                           for key, t0 in self._active.items()
                           if now - t0 > self.timeout
                           and key not in self._fired]
                for key, _ in overdue:
                    self._fired.add(key)
            for (name, _tok), elapsed in overdue:
                self.timeouts += 1
                _WD_TIMEOUTS.inc(1, section=name)
                rank = os.environ.get("PADDLE_TRAINER_ID", "0")
                warnings.warn(
                    f"[CommWatchdog] step '{name}' has not completed after "
                    f"{elapsed:.1f}s (timeout {self.timeout:g}s) on rank "
                    f"{rank}", RuntimeWarning)
                # the post-mortem record: the stuck section, the open
                # spans and the metrics at this instant
                flight_dump(f"watchdog:{name} after {elapsed:.1f}s "
                            f"(timeout {self.timeout:g}s, rank {rank})")

    @contextlib.contextmanager
    def section(self, name: str = "step"):
        """Watch the body as section `name` (concurrent and nested
        sections of one name are tracked apart)."""
        self._ensure_monitor()
        with self._lock:
            self._token += 1
            key = (name, self._token)
            self._active[key] = time.monotonic()
        try:
            with _span("watchdog." + name):
                yield
        finally:
            with self._lock:
                self._active.pop(key, None)
                self._fired.discard(key)

    def shutdown(self):
        """Stop the monitor thread."""
        self._stop.set()
