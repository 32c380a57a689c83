"""LRU result cache: repeat queries skip the PPR iteration entirely.

Keys are the service's ``_cache_key`` tuples — ``(graph, epoch, vertex,
precision, k, iterations, early_exit, warm)`` — the full identity of a served
recommendation, including the graph's delta epoch and the service numerics.
Scoped delta invalidation (``PPRService.apply_delta``) depends positionally
on that layout: its ``remap`` callback reads the epoch at index 1 and the
personalization vertex at index 2.  Hit/miss/eviction counters feed the
telemetry hit-rate.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional


class LRUCache:
    """Plain LRU over an OrderedDict; ``get`` refreshes recency."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._store: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        # membership probe only — does not touch counters or recency
        return key in self._store

    def get(self, key: Hashable) -> Optional[Any]:
        if key in self._store:
            self.hits += 1
            self._store.move_to_end(key)
            return self._store[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity == 0:
            return
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = value
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def remap(self, fn: Callable[[Hashable], Optional[Hashable]]
              ) -> "tuple[int, int]":
        """Rewrite every key through ``fn``: return a new key to retag the
        entry, the same key to keep it, or None to drop it.  Returns
        ``(dropped, retagged)``; drops count as invalidations.

        This is the scoped-invalidation primitive of delta ingestion: entries
        whose personalization vertex lies in a delta's affected frontier are
        dropped, everything else is retagged to the new epoch and keeps
        serving.  Recency order is preserved; if two keys collide after
        remapping, the more recently used entry wins (the older one counts as
        dropped)."""
        dropped = retagged = 0
        remapped: "OrderedDict[Hashable, Any]" = OrderedDict()
        for key, value in self._store.items():
            new_key = fn(key)
            if new_key is None:
                dropped += 1
                continue
            if new_key != key:
                retagged += 1
            if new_key in remapped:
                dropped += 1                 # older colliding entry gives way
                del remapped[new_key]        # re-insert at current recency
            remapped[new_key] = value
        self._store = remapped
        self.invalidations += dropped
        return dropped, retagged

    def invalidate(self, predicate: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose key satisfies ``predicate``; returns the
        count.  Used when a graph is re-registered under an existing name —
        its cached ranks describe the *old* topology and must not survive."""
        doomed = [k for k in self._store if predicate(k)]
        for k in doomed:
            del self._store[k]
        self.invalidations += len(doomed)
        return len(doomed)

    def map_values(self, fn: Callable[[Hashable, Any], Any]) -> None:
        """Replace every entry's value with ``fn(key, value)`` in place —
        recency order and counters untouched.  Delta ingestion grows stored
        warm-start columns through this (repro.graph_updates.warmstart)."""
        for key in self._store:
            self._store[key] = fn(key, self._store[key])

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "size": len(self._store),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "hit_rate": self.hit_rate,
        }
