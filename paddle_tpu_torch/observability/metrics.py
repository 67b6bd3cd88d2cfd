"""Process-wide metrics registry: named counters, gauges and fixed-bucket
histograms with labels (counterpart of
paddle_tpu/observability/metrics.py, stdlib only).

The registry is DISARMED by default and every record call —
`Counter.inc`, `Gauge.set`, `Histogram.observe` — returns on one
module-global bool check, so the instrumented paths cost nothing while
it is off. Arm it with `FLAGS_metrics=1` (the environment at import, or
`paddle_tpu_torch.set_flags`) or `observability.enable()`.

Instruments are created once at module level with a `subsystem.name`
snake-case id and then recorded through the returned handle:

    from ..observability import metrics as _m
    _SHEDS = _m.counter("serving.sheds_total", "waiting requests shed")
    ...
    _SHEDS.inc()                       # disarmed: one global load + bool
    _TTFT.observe(0.2, priority="1")   # labeled series

`counter()/gauge()/histogram()` are get-or-create: re-requesting an id
returns the existing instrument; requesting it as a different type
raises. `Histogram.observe(v, exemplar="<trace id>")` pins the last
`{trace_id, value, ts}` on the bucket the observation landed in, so a
tail bucket in the Prometheus text (`export.prometheus_text`) names a
request trace to pull at `GET /v1/trace/<id>`. Not ported yet:
collectors.
"""
from __future__ import annotations

import re
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "enable", "enabled", "snapshot", "reset", "instruments",
           "split_label_key", "DEFAULT_BUCKETS"]

# fast-path guard: every record call reads this module global and returns
# when False
_enabled = False

# reentrant: a snapshot taken from a signal handler may interrupt a
# record call that already holds a lock
_lock = threading.RLock()                # registry structure, not values
_instruments: Dict[str, "_Instrument"] = {}

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0)


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def _esc_label_value(v) -> str:
    """Escape the separators so that free-form values cannot merge two
    series into one key."""
    return (str(v).replace("\\", "\\\\").replace(",", "\\,")
            .replace("=", "\\="))


def _label_key(labels: Optional[dict]) -> str:
    """Flat 'k=v,k2=v2' series key (sorted; values escaped)."""
    if not labels:
        return ""
    return ",".join(f"{k}={_esc_label_value(labels[k])}"
                    for k in sorted(labels))


def split_label_key(key: str) -> List[Tuple[str, str]]:
    """Inverse of _label_key: [(k, v), ...] with escapes resolved (a
    char scanner: escapes consume in pairs, so a value ending in a
    backslash still parses)."""
    if not key:
        return []
    out = []
    k: list = []
    v: list = []
    cur = k
    i, n = 0, len(key)
    while i < n:
        c = key[i]
        if c == "\\" and i + 1 < n:
            cur.append(key[i + 1])
            i += 2
            continue
        if c == "=" and cur is k:
            cur = v
        elif c == ",":
            out.append(("".join(k), "".join(v)))
            k, v = [], []
            cur = k
        else:
            cur.append(c)
        i += 1
    out.append(("".join(k), "".join(v)))
    return out


class _Instrument:
    kind = "abstract"

    __slots__ = ("name", "help", "_values", "_vlock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict = {}
        self._vlock = threading.RLock()

    def snapshot(self) -> dict:
        with self._vlock:
            return dict(self._values)

    def reset(self) -> None:
        with self._vlock:
            self._values.clear()


class Counter(_Instrument):
    """Monotonic count, optionally per label set."""

    kind = "counter"
    __slots__ = ()

    def inc(self, n: float = 1, **labels) -> None:
        if not _enabled:
            return
        key = _label_key(labels)
        with self._vlock:
            self._values[key] = self._values.get(key, 0) + n


class Gauge(_Instrument):
    """Last-written value, optionally per label set."""

    kind = "gauge"
    __slots__ = ()

    def set(self, v: float, **labels) -> None:
        if not _enabled:
            return
        key = _label_key(labels)
        with self._vlock:
            self._values[key] = v


class Histogram(_Instrument):
    """Fixed-bucket histogram: per-bucket counts + sum + count per label
    set. Bucket bounds are upper-inclusive edges; an implicit +Inf bucket
    takes the tail. An observation with `exemplar=` also pins the last
    `{trace_id, value, ts}` on its bucket (OpenMetrics exemplars)."""

    kind = "histogram"
    __slots__ = ("buckets",)

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {name!r}: needs >= 1 bucket")
        self.buckets = b

    def observe(self, v: float, exemplar: Optional[str] = None,
                **labels) -> None:
        if not _enabled:
            return
        key = _label_key(labels)
        i = bisect_left(self.buckets, v)    # index of first bound >= v
        with self._vlock:
            cell = self._values.get(key)
            if cell is None:
                # [counts per bucket + overflow, sum, count,
                #  {bucket index: [trace_id, value, ts]}]
                cell = self._values[key] = \
                    [[0] * (len(self.buckets) + 1), 0.0, 0, {}]
            cell[0][i] += 1
            cell[1] += v
            cell[2] += 1
            if exemplar is not None:
                cell[3][i] = [str(exemplar), float(v), time.time()]

    def snapshot(self) -> dict:
        edges = ["%g" % b for b in self.buckets] + ["+Inf"]
        with self._vlock:
            out = {}
            for key, (counts, total, n, exemplars) in self._values.items():
                d = {"buckets": [[b, c] for b, c in
                                 zip(self.buckets, counts)]
                     + [["+Inf", counts[-1]]],
                     "sum": total, "count": n}
                if exemplars:
                    d["exemplars"] = {
                        edges[i]: {"trace_id": ex[0], "value": ex[1],
                                   "ts": ex[2]}
                        for i, ex in sorted(exemplars.items())}
                out[key] = d
            return out


def _get_or_create(cls, name: str, help: str, **kw):
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"metric id {name!r} must be snake_case 'subsystem.name' "
            f"(e.g. 'serving.sheds_total')")
    with _lock:
        inst = _instruments.get(name)
        if inst is not None:
            if type(inst) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, requested {cls.kind}")
            return inst
        inst = cls(name, help, **kw)
        _instruments[name] = inst
        return inst


def counter(name: str, help: str = "") -> Counter:
    return _get_or_create(Counter, name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _get_or_create(Gauge, name, help)


def histogram(name: str, help: str = "",
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _get_or_create(Histogram, name, help, buckets=buckets)


def instruments() -> Dict[str, _Instrument]:
    with _lock:
        return dict(_instruments)


def snapshot() -> dict:
    """{'counters': {id: {label_key: val}}, 'gauges': {...},
    'histograms': {id: {label_key: {'buckets': [[le, n]...], 'sum': s,
    'count': c}}}}."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for name, inst in sorted(instruments().items()):
        out[inst.kind + "s"][name] = inst.snapshot()
    return out


def reset() -> None:
    """Zero every instrument's values (the instruments stay registered)."""
    for inst in instruments().values():
        inst.reset()
