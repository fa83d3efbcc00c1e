"""Typed metric primitives + registry (counters, gauges, histograms).

The port's own copy of ``repro/obs/metrics.py`` (pure Python).

The registry is get-or-create by name with type checking — asking for an
existing name with a different metric type raises, so a counter can never be
silently shadowed by a gauge. ``snapshot()`` flattens everything into plain
dicts for the JSONL metrics stream (obs.recorder) and the end-of-run summary.

Names are dotted, lowest-level component last: ``ring.evictions``,
``transport.uplink_bytes`` — the reference's table lives in
docs/observability.md.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing count (events, bytes, cache misses)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (ring occupancy, in-flight count)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Streaming summary of observations (latencies): count/sum/min/max/mean
    plus an exact mean-of-squares for the stddev — no buckets, no deps."""

    __slots__ = ("name", "count", "total", "sq_total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.sq_total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: Number) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.sq_total += v * v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        mean = self.total / self.count
        var = max(self.sq_total / self.count - mean * mean, 0.0)
        return {"count": self.count, "sum": self.total, "mean": mean,
                "min": self.min, "max": self.max, "std": math.sqrt(var)}


class MetricsRegistry:
    """Get-or-create store of named metrics with type enforcement."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, requested as "
                f"{cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def hist(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {"counters": {}, "gauges": {},
                                          "histograms": {}}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out
