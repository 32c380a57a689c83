"""Async result-cache prefetcher — warm predicted-hot vertices between waves.

Counterpart of ``repro.ppr_serving.prefetch`` (host Python, copied).

The ROADMAP follow-on: the LRU result cache and wave telemetry were built so
that a prefetcher could be *measured*, not just bolted on.  ``Prefetcher``
ranks personalization vertices by recent real-query frequency (telemetry's
``query_vertex_counts``) and, during idle pumps (no wave was launchable), the
service issues synthetic ``PPRQuery``s for the hottest uncached vertices and
launches them immediately.  Their results land in the LRU exactly like real
wave results, so the warmed-hit-rate shows up in the existing ``lru_*``
counters: synthetic traffic never touches the submit-path ``cache_*`` /
``lru_*`` hit/miss stats (membership probes are counter-free), so every hit
they later absorb is a real query that skipped its wave.

Synthetic queries are issued under the cache key real traffic probes: each
vertex's last real (k, resolved precision) when telemetry has seen one —
``precision="auto"`` traffic records its post-resolution format, which is the
rung the controller would resolve next — falling back to the config's ``k``
at the controller's currently resolved format for the graph.

Composition with delta ingestion: ``PPRService.apply_delta`` reports the hot
vertices its scoped invalidation dropped; they enter the re-warm queue and are
re-issued ahead of merely-popular vertices on the next idle pump.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Mapping, MutableMapping, Optional


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Policy for synthetic cache-warming traffic.

    ``top_n``        hottest vertices considered per graph per idle pump.
    ``k``            fallback top-k for synthetic queries; the service prefers
                     the vertex's last real-query k so the warmed cache key is
                     the one real traffic probes (clamped to the graph's V-1).
    ``max_per_pump`` global cap on synthetic queries issued per idle pump —
                     prefetch compute must never crowd out a real wave.
    ``min_count``    a vertex must have this many recent real queries to be
                     considered hot (and to earn a re-warm after a delta).
    ``half_life_s``  exponential half-life of the demand counts (seconds):
                     before each idle pump ranks candidates, every vertex's
                     count is scaled by ``0.5 ** (elapsed / half_life_s)`` —
                     a vertex hot an hour ago no longer ranks hot forever.
                     None (the default) keeps the legacy cumulative counts.
    ``suppress_depth`` admission-queue depth at which an otherwise-idle poll
                     skips prefetch entirely: pending live queries mean the
                     service is between waves, not idle, and synthetic warm-up
                     compute must yield.  None (the default) uses the
                     service's κ — a full wave's worth queued is traffic.
    """
    top_n: int = 16
    k: int = 10
    max_per_pump: int = 8
    min_count: int = 2
    half_life_s: Optional[float] = None
    suppress_depth: Optional[int] = None

    def __post_init__(self):
        if self.top_n < 1 or self.k < 1 or self.max_per_pump < 1:
            raise ValueError("top_n, k and max_per_pump must be >= 1")
        if self.min_count < 1:
            raise ValueError("min_count must be >= 1")
        if self.half_life_s is not None and not self.half_life_s > 0:
            raise ValueError(f"half_life_s must be > 0 (or None), "
                             f"got {self.half_life_s}")
        if self.suppress_depth is not None and self.suppress_depth < 1:
            raise ValueError(f"suppress_depth must be >= 1 (or None), "
                             f"got {self.suppress_depth}")


class Prefetcher:
    """Rank hot vertices; remember delta-invalidated ones for re-warming."""

    def __init__(self, config: PrefetchConfig = PrefetchConfig(),
                 time_fn=time.monotonic):
        self.config = config
        self.time_fn = time_fn           # injectable clock (demand decay)
        # graph → ordered set of delta-invalidated hot vertices (FIFO)
        self._rewarm: Dict[str, "OrderedDict[int, None]"] = {}
        # graph → last demand-decay timestamp; a graph never decayed before
        # falls back to the construction stamp, so demand accumulated during
        # a long poll-free stretch still ages on the *first* idle poll
        self._last_decay: Dict[str, float] = {}
        self._start = time_fn()
        self.issued = 0
        self.rewarms_queued = 0
        self.suppressed = 0            # idle polls skipped: live queue was deep

    def decay_demand(self, graph: str, counts: MutableMapping[int, float],
                     now: Optional[float] = None,
                     last_seen: Optional[MutableMapping[int, tuple]] = None
                     ) -> None:
        """Exponentially age ``counts`` in place by the time elapsed since the
        last decay of this graph (no-op without a configured half-life).

        Counts that cool below a small floor are pruned outright — they can
        never clear ``min_count`` again without fresh traffic, and pruning
        keeps the demand map from accumulating dead vertices.  ``last_seen``
        (telemetry's per-vertex (k, precision) map) is pruned in lockstep:
        its only other pruning path is the compaction threshold on the counts
        map, which decay keeps small enough to never fire — without this it
        would grow one entry per vertex ever queried."""
        hl = self.config.half_life_s
        if hl is None:
            return
        now = self.time_fn() if now is None else now
        last = self._last_decay.get(graph, self._start)
        if now <= last:
            return               # stamps only advance: an out-of-order `now`
        self._last_decay[graph] = now   # must not rewind and over-age later
        factor = 0.5 ** ((now - last) / hl)
        for v in list(counts):
            cooled = counts[v] * factor
            if cooled < 0.05:
                del counts[v]
                if last_seen is not None:
                    last_seen.pop(v, None)
            else:
                counts[v] = cooled

    def note_invalidated(self, graph: str, vertices: Iterable[int]) -> None:
        """Hot vertices whose cache entries a delta's scoped invalidation
        dropped: first in line at the next idle pump."""
        queue = self._rewarm.setdefault(graph, OrderedDict())
        for v in vertices:
            if int(v) not in queue:
                queue[int(v)] = None
                self.rewarms_queued += 1

    def drop_graph(self, graph: str) -> None:
        """Full re-registration: queued re-warms describe a dead topology."""
        self._rewarm.pop(graph, None)
        self._last_decay.pop(graph, None)

    def candidates(self, graph: str, counts: Mapping[int, int],
                   limit: Optional[int] = None) -> List[int]:
        """Up to ``limit`` vertices worth warming, most urgent first: the
        re-warm queue (consumed FIFO, but only as many as ``limit`` allows —
        the remainder stays queued for the next idle pump), then the
        ``top_n`` hottest by real-query count.  The caller filters out
        vertices that are already cached or out of range."""
        limit = self.config.max_per_pump if limit is None else limit
        out: List[int] = []
        queue = self._rewarm.get(graph)
        while queue and len(out) < limit:
            v, _ = queue.popitem(last=False)
            out.append(v)
        hot = heapq.nsmallest(
            self.config.top_n,
            (v for v, n in counts.items() if n >= self.config.min_count),
            key=lambda v: (-counts[v], v))
        for v in hot:
            if len(out) >= limit:
                break
            if v not in out:
                out.append(v)
        return out

    def stats(self) -> Dict[str, float]:
        return {
            "issued": self.issued,
            "suppressed": self.suppressed,
            "rewarms_queued": self.rewarms_queued,
            "rewarms_pending": sum(len(q) for q in self._rewarm.values()),
        }
