"""Bounded per-graph store of last-converged PPR columns (warm-start seeds).

Counterpart of ``repro.graph_updates.warmstart``.

PPR's eq. (1) iteration is a contraction toward a personalization-pinned
stationary state: the starting point only decides the trajectory length, not
the destination.  After a topology delta, the pre-delta converged column of a
personalization vertex is therefore a far better ``V0`` than the one-hot
restart — the convergence monitor (repro_torch.autotune.convergence) reaches
the absorbing state / epsilon exit in a fraction of the cold iterations.

On the fixed path the absorbing state reached from a warm seed can differ
from the cold trajectory's by trailing LSBs of quantization noise (truncation
is path-dependent); rankings agree in practice.  Queries needing the
bit-exact cold result run on a service with ``warm_start`` off — the cache
key's warm flag keeps the two result families from aliasing.

Columns are host numpy arrays in the precision domain they were served at:
float32 for the f32 path, and for a Q format its raw bits as ``uint32``, as
in the reference (the service converts the int32 bits of the port's states
with one ``view`` at ``put`` and back at ``get``; keys carry the precision
key, so domains never mix), one ``LRUCache`` per graph keyed
``(vertex, precision)``.  ``grow`` zero-pads every stored column when a delta
grows the vertex space: new vertices start with zero rank, exactly what a
cold restart would give them.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

if TYPE_CHECKING:  # typing only — see the lazy import in __init__
    from repro_torch.ppr_serving.cache import LRUCache


class WarmStartStore:
    """Per-graph LRU of converged state columns keyed (vertex, precision)."""

    def __init__(self, capacity_per_graph: int = 512):
        # imported lazily: ppr_serving.service imports this module, so a
        # module-level import of the ppr_serving package would be circular
        # when repro_torch.graph_updates is imported first
        from repro_torch.ppr_serving.cache import LRUCache
        if capacity_per_graph < 0:
            raise ValueError(
                f"capacity_per_graph must be >= 0, got {capacity_per_graph}")
        self.capacity_per_graph = capacity_per_graph
        self._lru_cls = LRUCache
        self._stores: Dict[str, "LRUCache"] = {}

    def __len__(self) -> int:
        return sum(len(s) for s in self._stores.values())

    def _store(self, graph: str) -> "LRUCache":
        if graph not in self._stores:
            self._stores[graph] = self._lru_cls(self.capacity_per_graph)
        return self._stores[graph]

    def get(self, graph: str, vertex: int, pkey: str) -> Optional[np.ndarray]:
        return self._store(graph).get((int(vertex), pkey))

    def put(self, graph: str, vertex: int, pkey: str, column: np.ndarray) -> None:
        self._store(graph).put((int(vertex), pkey), column)

    def grow(self, graph: str, new_num_vertices: int) -> None:
        """Zero-pad every stored column of ``graph`` to the grown vertex count
        (no-op for columns already that long)."""
        store = self._stores.get(graph)
        if store is None:
            return

        def pad(_key, col):
            n = new_num_vertices - col.shape[0]
            return np.concatenate([col, np.zeros(n, col.dtype)]) if n > 0 else col

        store.map_values(pad)

    def drop_graph(self, graph: str) -> int:
        """Full re-registration: stored columns describe a dead topology."""
        store = self._stores.pop(graph, None)
        return len(store) if store is not None else 0

    def stats(self) -> Dict[str, float]:
        agg = {"hits": 0, "misses": 0, "evictions": 0}
        for store in self._stores.values():
            s = store.stats()
            for k in agg:
                agg[k] += s[k]
        return {
            "size": len(self),
            "capacity_per_graph": self.capacity_per_graph,
            **{k: float(v) for k, v in agg.items()},
        }
