"""Bounded metrics registry — counters, gauges, histograms, reservoirs.

The serving stack's telemetry kept unbounded per-wave lists (every wave
latency, every shadow score, forever); a long-lived server leaks.  This
module is the bounded replacement: every instrument here holds O(1) state in
the number of observations —

``Counter``     monotone float/int total.
``Gauge``       last value + running peak (the admission-queue gauges need
                "what is it now" *and* "how bad did it get").
``Histogram``   exponential (or explicit) bucket counts + exact sum/count.
                Sum and count make means exact; the buckets bound the tail's
                memory at the cost of percentile resolution.
``Reservoir``   fixed-size uniform sample (Vitter's Algorithm R) with a
                *seeded* RNG, so percentile estimates are deterministic under
                replayed traffic.  While fewer observations than ``size``
                have arrived the reservoir holds all of them, so small runs
                (every test, every bench warm-up) report *exact* percentiles
                — only a long-lived server degrades gracefully to a sample.

Instruments live in a ``MetricsRegistry`` keyed by metric name; a metric may
carry label dimensions (``registry.counter("served", labels=("precision",))``
then ``.labels(precision="f32").inc()``), and the per-family series count is
capped (``max_series``) so a label-cardinality bug degrades into one overflow
series instead of an unbounded map — the registry itself obeys the bound it
exists to enforce.

The registry is exporter-agnostic: ``collect()`` yields plain sample tuples
that repro.obs.export renders as Prometheus text exposition or JSON.
"""
from __future__ import annotations

import bisect
import math
import random
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Reservoir", "MetricsRegistry",
    "exponential_buckets",
]

#: label-values key of the unlabeled (single-series) child of a family
_NO_LABELS: Tuple[str, ...] = ()

#: the series every over-cardinality observation collapses into
OVERFLOW_LABEL = "_overflow"


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` upper bounds ``start, start*factor, ...`` (no +Inf — every
    histogram implicitly owns the overflow bucket)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"need start > 0, factor > 1, count >= 1; "
            f"got {start}/{factor}/{count}")
    return tuple(start * factor ** i for i in range(count))


#: default latency bounds: 1 µs .. ~137 s in doublings (28 buckets)
LATENCY_BUCKETS = exponential_buckets(1e-6, 2.0, 28)


class Counter:
    """Monotone total; ``inc`` only goes up."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Gauge:
    """Last-written value plus its running peak."""

    __slots__ = ("value", "peak")

    def __init__(self) -> None:
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if v > self.peak:
            self.peak = float(v)


class Histogram:
    """Cumulative-bucket histogram with exact ``sum``/``count``.

    ``bounds`` are upper bounds in ascending order; observations above the
    last bound land in the implicit overflow bucket (rendered ``le="+Inf"``).
    """

    __slots__ = ("bounds", "bucket_counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"bounds must be non-empty ascending, got {bounds}")
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)   # +1: overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative(self) -> List[Tuple[float, int]]:
        """``(le, cumulative_count)`` per bound, ending with (+inf, count)."""
        out: List[Tuple[float, int]] = []
        running = 0
        for b, n in zip(self.bounds, self.bucket_counts):
            running += n
            out.append((b, running))
        out.append((math.inf, self.count))
        return out


class Reservoir:
    """Fixed-size uniform sample of an unbounded observation stream.

    Algorithm R with a seeded ``random.Random`` — two services replaying the
    same traffic hold identical reservoirs, which keeps percentile-based
    assertions and benches deterministic.  ``values()`` returns observations
    in arrival order (evictions replace in place), so while ``n_seen <= size``
    it is exactly the full history.
    """

    __slots__ = ("size", "n_seen", "sum", "_values", "_rng")

    def __init__(self, size: int = 1024, seed: int = 0):
        if size < 1:
            raise ValueError(f"reservoir size must be >= 1, got {size}")
        self.size = size
        self.n_seen = 0
        self.sum = 0.0                     # over every observation ever seen
        self._values: List[float] = []
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.n_seen += 1
        self.sum += float(v)
        if len(self._values) < self.size:
            self._values.append(float(v))
            return
        j = self._rng.randrange(self.n_seen)
        if j < self.size:
            self._values[j] = float(v)

    def values(self) -> List[float]:
        return list(self._values)

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile of the held sample (0 when empty)."""
        if not self._values:
            return 0.0
        vals = sorted(self._values)
        pos = (len(vals) - 1) * (q / 100.0)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac


_KINDS = {"counter": Counter, "gauge": Gauge}


class _Family:
    """One named metric and its labeled children (bounded)."""

    def __init__(self, name: str, kind: str, help: str,
                 labels: Tuple[str, ...], max_series: int,
                 make_child) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = labels
        self.max_series = max_series
        self._make_child = make_child
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labels:                    # unlabeled: materialize eagerly so
            self._children[_NO_LABELS] = make_child()   # zero values export

    def labels(self, **kv: str):
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.label_names)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_series:
                # cardinality bug containment: collapse into one series
                key = tuple(OVERFLOW_LABEL for _ in self.label_names)
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._make_child()
                return child
            child = self._children[key] = self._make_child()
        return child

    def get(self):
        """The unlabeled child (only valid on label-less families)."""
        if self.label_names:
            raise ValueError(f"metric {self.name!r} is labeled "
                             f"({self.label_names}) — use .labels()")
        return self._children[_NO_LABELS]

    def series(self) -> Iterable[Tuple[Tuple[Tuple[str, str], ...], object]]:
        """``((label, value), ...) → instrument`` pairs, label-sorted."""
        for key in sorted(self._children):
            yield tuple(zip(self.label_names, key)), self._children[key]


class MetricsRegistry:
    """Name → family index; get-or-create, type-checked, bounded.

    ``reservoir_size`` is the percentile sample bound every ``reservoir()``
    defaults to — the one knob that trades percentile fidelity for memory.
    """

    def __init__(self, reservoir_size: int = 1024, max_series: int = 256):
        if reservoir_size < 1:
            raise ValueError(f"reservoir_size must be >= 1, "
                             f"got {reservoir_size}")
        self.reservoir_size = reservoir_size
        self.max_series = max_series
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------------
    def _family(self, name: str, kind: str, help: str,
                labels: Tuple[str, ...], make_child) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != labels:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} with "
                    f"labels {fam.label_names}; asked for {kind}/{labels}")
            return fam
        fam = _Family(name, kind, help, labels, self.max_series, make_child)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, tuple(labels), Counter)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, tuple(labels), Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  bounds: Sequence[float] = LATENCY_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, tuple(labels),
                            lambda: Histogram(bounds))

    def reservoir(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  size: Optional[int] = None, seed: int = 0) -> _Family:
        n = self.reservoir_size if size is None else size
        return self._family(name, "reservoir", help, tuple(labels),
                            lambda: Reservoir(n, seed=seed))

    # ------------------------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self._families)

    def collect(self) -> List[Tuple[str, str, str, List[Tuple[Tuple[Tuple[str, str], ...], object]]]]:
        """``(name, kind, help, [(labels, instrument), ...])`` per family,
        name-sorted — the exporter contract."""
        return [(name, fam.kind, fam.help, list(fam.series()))
                for name, fam in sorted(self._families.items())]

    def as_dict(self) -> Dict[str, object]:
        """Flat JSON-ready snapshot: scalar instruments become numbers,
        histograms/reservoirs become summary dicts.  Labeled series append
        ``{label=value,...}`` to the key, Prometheus-style."""
        out: Dict[str, object] = {}
        for name, kind, _help, series in self.collect():
            for labels, inst in series:
                key = name
                if labels:
                    key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
                if kind == "counter":
                    out[key] = inst.value
                elif kind == "gauge":
                    out[key] = inst.value
                    out[key + "_peak"] = inst.peak
                elif kind == "histogram":
                    out[key] = {"count": inst.count, "sum": inst.sum,
                                "mean": inst.mean}
                else:                                   # reservoir
                    out[key] = {"n_seen": inst.n_seen,
                                "p50": inst.percentile(50),
                                "p95": inst.percentile(95),
                                "p99": inst.percentile(99)}
        return out
