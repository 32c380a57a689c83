"""`EdgeDelta` — one batched topology update against a live graph.

Counterpart of ``repro.graph_updates.delta``, copied: the same numpy
``Generator`` calls in the same order, so a seed gives the same delta in both
packages.

A delta is the host-side unit of dynamic-graph ingestion (the CPU prepares
and patches the sparse structure while the accelerator keeps streaming it —
the CPU–FPGA synergy argument of arXiv 2004.13907): lists of edges to add and
remove, plus optional vertex growth.  ``apply`` merges it into a ``COOGraph``
through ``repro_torch.core.coo.merge_edge_delta``, which renormalizes ``val`` and
``dangling`` only for touched source vertices and returns the bookkeeping for
incremental requantization / shard repartitioning.

``affected_frontier`` is the scoped-invalidation surface: the delta's touched
vertices plus their in-neighbors — every personalization vertex whose cached
top-K sees a first-order (one-hop, α-weighted) rank shift.  Entries outside
the frontier see only multi-hop, α²-damped mass shifts and are retained as
bounded-staleness approximations instead of being dropped with the whole
graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.coo import COOGraph, EdgeMergeInfo, merge_edge_delta


def _edge_array(a) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(a, np.int64))
    if arr.ndim != 1:
        raise ValueError(f"edge endpoint list must be 1-D, got shape {arr.shape}")
    return arr


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeDelta:
    """A batch of edge insertions/deletions and optional vertex growth.

    ``add_src[i] -> add_dst[i]`` are inserted, ``remove_src[i] -> remove_dst[i]``
    removed (one multi-edge instance per request; removing a missing edge is an
    error).  ``new_num_vertices`` may only grow the vertex space.

    ``eq=False``: a generated ``__eq__`` over ndarray fields would raise on
    comparison (ambiguous array truth value) — identity semantics instead.
    """

    add_src: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    add_dst: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    remove_src: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    remove_dst: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    new_num_vertices: Optional[int] = None

    def __post_init__(self):
        for f in ("add_src", "add_dst", "remove_src", "remove_dst"):
            object.__setattr__(self, f, _edge_array(getattr(self, f)))
        if self.add_src.shape != self.add_dst.shape:
            raise ValueError("add_src/add_dst length mismatch")
        if self.remove_src.shape != self.remove_dst.shape:
            raise ValueError("remove_src/remove_dst length mismatch")

    @property
    def num_added(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_removed(self) -> int:
        return int(self.remove_src.shape[0])

    @property
    def num_edges(self) -> int:
        return self.num_added + self.num_removed

    def touched_vertices(self) -> np.ndarray:
        """Every endpoint of an added or removed edge (sorted, unique)."""
        return np.unique(np.concatenate(
            [self.add_src, self.add_dst, self.remove_src, self.remove_dst]))

    def affected_frontier(self, g: COOGraph) -> np.ndarray:
        """Touched vertices plus their in-neighbors in ``g`` (the pre-delta
        graph).  Added edges contribute no extra in-neighbors: an added edge
        into a touched vertex has a touched source by construction."""
        touched = self.touched_vertices()
        if touched.size == 0:
            return touched
        into_touched = np.isin(g.x, touched)
        return np.unique(np.concatenate(
            [touched, g.y[into_touched].astype(np.int64)]))

    def apply(self, g: COOGraph,
              outdeg: Optional[np.ndarray] = None
              ) -> Tuple[COOGraph, EdgeMergeInfo]:
        """Merge this delta into ``g`` (see ``merge_edge_delta``)."""
        return merge_edge_delta(
            g, self.add_src, self.add_dst, self.remove_src, self.remove_dst,
            new_num_vertices=self.new_num_vertices, outdeg=outdeg)


def random_delta(g: COOGraph, rng: np.random.Generator,
                 n_add: int = 16, n_remove: int = 8, grow: int = 0,
                 center: Optional[int] = None) -> EdgeDelta:
    """Synthesize a plausible delta against ``g`` (benchmarks / replay).

    ``center`` localizes the delta to the 1-hop neighborhood of one vertex
    (the scoped-invalidation showcase); otherwise endpoints are global.
    ``grow`` appends that many new vertices, each wired to one existing vertex
    so growth is observable in served rankings, not just shapes.
    """
    v = g.num_vertices
    if center is not None:
        nbhd = np.unique(np.concatenate(
            [[center], g.y[g.x == center], g.x[g.y == center]])).astype(np.int64)
        rem_pool = np.nonzero(np.isin(g.x, nbhd) | np.isin(g.y, nbhd))[0]
    else:
        nbhd = None
        rem_pool = np.arange(g.num_edges)
    n_remove = min(n_remove, rem_pool.shape[0])
    rem_idx = rng.choice(rem_pool, size=n_remove, replace=False) \
        if n_remove else np.zeros(0, np.int64)
    remove_src = g.y[rem_idx].astype(np.int64)
    remove_dst = g.x[rem_idx].astype(np.int64)
    pool = nbhd if nbhd is not None and nbhd.size >= 2 else np.arange(v)
    add_src = rng.choice(pool, size=n_add) if n_add else np.zeros(0, np.int64)
    add_dst = rng.choice(pool, size=n_add) if n_add else np.zeros(0, np.int64)
    new_v = None
    if grow:
        new_ids = np.arange(v, v + grow, dtype=np.int64)
        add_src = np.concatenate([add_src, new_ids])
        add_dst = np.concatenate([add_dst, rng.integers(0, v, grow)])
        new_v = v + grow
    return EdgeDelta(add_src=add_src, add_dst=add_dst,
                     remove_src=remove_src, remove_dst=remove_dst,
                     new_num_vertices=new_v)


def localized_delta(g: COOGraph, rng: np.random.Generator,
                    n_add: int = 4, n_remove: int = 1) -> EdgeDelta:
    """A delta whose affected frontier stays genuinely small.

    On heavy-tailed graphs almost every edge is incident to a hub, and
    touching a hub puts the hub's entire in-neighborhood in the frontier —
    ``random_delta(center=...)`` therefore still invalidates most of the
    cache.  This variant draws endpoints from the lowest-connectivity
    vertices (added edges among the quietest vertices, removed edges ranked
    by the combined degree of both endpoints), the scoped-invalidation
    showcase case: a localized update drops strictly fewer cache entries than
    a whole-graph flush.
    """
    conn = np.bincount(g.x, minlength=g.num_vertices).astype(np.int64) \
        + np.bincount(g.y, minlength=g.num_vertices)
    pool = np.argsort(conn, kind="stable")[: max(8, 2 * (n_add + n_remove))]
    add_src = rng.choice(pool, n_add) if n_add else np.zeros(0, np.int64)
    add_dst = rng.choice(pool, n_add) if n_add else np.zeros(0, np.int64)
    n_remove = min(n_remove, g.num_edges)
    if n_remove:
        score = conn[g.x] + conn[g.y]
        rem_idx = np.argsort(score, kind="stable")[:n_remove]
        remove_src = g.y[rem_idx].astype(np.int64)
        remove_dst = g.x[rem_idx].astype(np.int64)
    else:
        remove_src = remove_dst = np.zeros(0, np.int64)
    return EdgeDelta(add_src=add_src, add_dst=add_dst,
                     remove_src=remove_src, remove_dst=remove_dst)
