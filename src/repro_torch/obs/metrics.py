"""Metrics registry: named counters / gauges / histograms (the port's own
copy of ``repro/obs/metrics.py``; stdlib only).

Every component registers its instruments by dotted name and
``snapshot()`` returns the whole state as one flat dict.  A ``Tracer``
given ``registry=`` mirrors every closed span into a histogram named
``span.<name>`` (microseconds).  Instruments are deliberately tiny
(``__slots__``, integer/float fields, no locks) so an increment costs
nothing beyond itself.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple


class Counter:
    """Monotonically increasing integer count."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-set value (occupancy, queue depth, ...)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Streaming distribution: count/sum/min/max plus log2 buckets.

    Buckets hold counts per ``floor(log2(x))`` decade (negative values
    and zero land in dedicated buckets), giving quantile *estimates*
    (upper bucket bound) without retaining observations — a 100K-event
    run observes every step's latency without growing memory.
    """

    __slots__ = ("name", "count", "total", "min", "max", "_buckets")
    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}

    @staticmethod
    def _bucket_of(x: float) -> int:
        if x <= 0:
            return -(2 ** 30)              # non-positive sentinel bucket
        return int(math.floor(math.log2(x)))

    def observe(self, x: float) -> None:
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        b = self._bucket_of(x)
        self._buckets[b] = self._buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the ``q`` quantile from the log2
        buckets (exact to within one power of two)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for b in sorted(self._buckets):
            seen += self._buckets[b]
            if seen >= target:
                return self.max if b == self._bucket_of(self.max) else 2.0 ** (b + 1)
        return self.max

    def snapshot(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Names are dotted paths (``span.serve.decode_step``); re-requesting a
    name returns the same instrument, and requesting it as a different kind
    raises.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(Histogram, name)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        return iter(sorted(self._metrics.items()))

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Flat name -> value dict (histograms nest their stats dict)."""
        return {name: m.snapshot() for name, m in self}
