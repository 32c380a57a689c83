"""COO graph container + packetization (paper §3, §4.1).

Counterpart of ``repro.core.coo``: host numpy, copied so that the port
builds array-equal layouts, and ``merge_edge_delta`` merges an edge delta
into bit-identical arrays.

The paper streams the graph as three equal arrays (x=dst, y=src, val) in packets of
B edges.  The matrix is additionally 2-D blocked by (dst_tile, src_tile): the
reference's TPU kernel keeps one P_t source slice and one accumulator slice in
VMEM.  The port's CUDA kernels do not walk these blocks: both read the pad-free
dst stream built from them (CSR over dst rows, cut into equal slices of edges;
see ``repro_torch.kernels.dst_stream``).

Padding discipline: sentinel edges have val=0 and x=y=0 inside their block, so they
contribute nothing while keeping every block a whole number of packets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.fixed_point import QFormat


@dataclasses.dataclass
class COOGraph:
    """A directed graph as the transposed transition matrix X = (D^-1 A)^T in COO.

    x[e] = destination row of X (the vertex receiving rank),
    y[e] = source column (the vertex sending rank),
    val[e] = 1/outdeg(y[e]).
    ``dangling`` marks vertices with no outgoing edges.
    """

    num_vertices: int
    x: np.ndarray          # int32 [E]
    y: np.ndarray          # int32 [E]
    val: np.ndarray        # float32 [E]
    dangling: np.ndarray   # bool [V]

    @property
    def num_edges(self) -> int:
        return int(self.x.shape[0])

    @property
    def sparsity(self) -> float:
        v = self.num_vertices
        return self.num_edges / float(v * v)

    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int) -> "COOGraph":
        """Build X = (D^-1 A)^T from raw (src → dst) edge list.

        X[dst, src] = 1/outdeg(src): entry (x=dst, y=src).
        """
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        outdeg = np.bincount(src, minlength=num_vertices).astype(np.int64)
        dangling = outdeg == 0
        val = (1.0 / outdeg[src]).astype(np.float32)
        # Sort by destination (x), then source — the streaming order the paper uses
        # (their FSM requires x to be monotone within the stream).
        order = np.lexsort((src, dst))
        return COOGraph(
            num_vertices=num_vertices,
            x=dst[order].astype(np.int32),
            y=src[order].astype(np.int32),
            val=val[order],
            dangling=dangling,
        )

    # ------------------------------------------------------------------
    def quantized_val(self, fmt: QFormat) -> np.ndarray:
        """Edge values truncated into the Q format (raw uint32)."""
        return quantize_values(self.val, fmt)

    def pad_to_packets(self, packet: int) -> "COOGraph":
        """Pad the edge stream to a whole number of B-edge packets (val=0 sentinels)."""
        e = self.num_edges
        pe = (e + packet - 1) // packet * packet
        if pe == e:
            return self
        pad = pe - e
        return COOGraph(
            num_vertices=self.num_vertices,
            x=np.concatenate([self.x, np.zeros(pad, np.int32)]),
            y=np.concatenate([self.y, np.zeros(pad, np.int32)]),
            val=np.concatenate([self.val, np.zeros(pad, np.float32)]),
            dangling=self.dangling,
        )


@dataclasses.dataclass
class EdgeMergeInfo:
    """Bookkeeping from ``merge_edge_delta`` for incremental downstream refresh.

    The merged graph is bit-identical to a from-scratch ``from_edges`` build,
    but consumers holding per-edge derived state (quantized raw values, shard
    partitions) should not recompute it wholesale: ``kept_old_idx`` /
    ``new_pos_of_kept`` map surviving edges old→new so untouched derived
    entries are copied, and ``changed_mask`` marks exactly the merged entries
    whose ``val`` differs from the pre-merge arrays (every edge of a touched
    source, which includes every added edge) — only those need requantizing.
    """

    kept_old_idx: np.ndarray      # int64 [n_kept]  surviving old edge ids
    new_pos_of_kept: np.ndarray   # int64 [n_kept]  their slots in the merged arrays
    changed_mask: np.ndarray      # bool  [E_new]   merged entries with a new val
    touched_sources: np.ndarray   # int64           sources whose out-degree changed
    changed_dst: np.ndarray       # int64           dsts owning a changed or removed edge
    new_outdeg: np.ndarray        # int64 [V_new]   post-merge out-degrees
    num_added: int
    num_removed: int


def merge_edge_delta(
    g: COOGraph,
    add_src: np.ndarray,
    add_dst: np.ndarray,
    remove_src: np.ndarray,
    remove_dst: np.ndarray,
    new_num_vertices: Optional[int] = None,
    outdeg: Optional[np.ndarray] = None,
) -> Tuple[COOGraph, EdgeMergeInfo]:
    """Apply an edge delta host-side, renormalizing only touched sources.

    Returns a merged ``COOGraph`` whose arrays are **bit-identical** to
    ``COOGraph.from_edges`` on the post-delta edge list (same (dst, src)
    streaming order, same ``1/outdeg`` float32 values), without resorting the
    whole stream or recomputing untouched values: surviving edges keep their
    position order and their ``val`` bits; only edges whose source gained or
    lost an out-edge are renormalized (``val`` is a pure function of the
    source's out-degree).

    ``remove_*`` must name existing edges; each request removes one instance
    (multi-edges carry multiplicity).  ``new_num_vertices`` may only grow the
    vertex space — new vertices are dangling until the delta wires them.
    ``outdeg`` (int64 [V]) lets a caller that tracks out-degrees skip the
    ``bincount`` over the old stream.
    """
    v_old = g.num_vertices
    v_new = v_old if new_num_vertices is None else int(new_num_vertices)
    if v_new < v_old:
        raise ValueError(
            f"new_num_vertices={v_new} shrinks the graph (|V|={v_old}); "
            f"vertex removal is not supported")
    add_src = np.atleast_1d(np.asarray(add_src, np.int64))
    add_dst = np.atleast_1d(np.asarray(add_dst, np.int64))
    remove_src = np.atleast_1d(np.asarray(remove_src, np.int64))
    remove_dst = np.atleast_1d(np.asarray(remove_dst, np.int64))
    if add_src.shape != add_dst.shape or remove_src.shape != remove_dst.shape:
        raise ValueError("src/dst length mismatch in edge delta")
    for name, arr, bound in (("add", add_src, v_new), ("add", add_dst, v_new),
                             ("remove", remove_src, v_old),
                             ("remove", remove_dst, v_old)):
        if arr.size and (arr.min() < 0 or arr.max() >= bound):
            raise ValueError(f"{name} edge endpoint out of range [0, {bound})")

    if outdeg is None:
        outdeg = np.bincount(g.y, minlength=v_old).astype(np.int64)
    new_outdeg = np.zeros(v_new, np.int64)
    new_outdeg[:v_old] = outdeg
    np.add.at(new_outdeg, add_src, 1)
    np.subtract.at(new_outdeg, remove_src, 1)
    if new_outdeg.min(initial=0) < 0:
        raise ValueError("delta removes more out-edges than some vertex has")

    # ---- removal: locate one stream slot per requested (src, dst) ---------
    # the stream is lexsorted by (dst=x, src=y), so x·M + y is sorted
    M = np.int64(max(v_new, 1))
    keys = g.x.astype(np.int64) * M + g.y.astype(np.int64)
    keep = np.ones(g.num_edges, bool)
    if remove_src.size:
        rem_keys, rem_counts = np.unique(remove_dst * M + remove_src,
                                         return_counts=True)
        lo = np.searchsorted(keys, rem_keys, side="left")
        hi = np.searchsorted(keys, rem_keys, side="right")
        short = rem_counts > (hi - lo)
        if short.any():
            k = rem_keys[short.argmax()]
            raise ValueError(
                f"delta removes edge ({k % M} -> {k // M}) more times than it "
                f"exists in the graph")
        for a, c in zip(lo, rem_counts):
            keep[a:a + c] = False
    kept_old_idx = np.nonzero(keep)[0]
    n_kept = kept_old_idx.shape[0]

    # ---- order-preserving merge of kept stream + sorted additions ---------
    add_order = np.lexsort((add_src, add_dst))
    add_src, add_dst = add_src[add_order], add_dst[add_order]
    add_keys = add_dst * M + add_src
    kept_keys = keys[kept_old_idx]
    # equal keys: kept edges first (ties are identical tuples either way)
    new_pos_of_add = np.searchsorted(kept_keys, add_keys, side="right") \
        + np.arange(add_keys.shape[0], dtype=np.int64)
    new_pos_of_kept = np.arange(n_kept, dtype=np.int64) \
        + np.searchsorted(add_keys, kept_keys, side="left")
    e_new = n_kept + add_keys.shape[0]
    x_new = np.empty(e_new, np.int32)
    y_new = np.empty(e_new, np.int32)
    val_new = np.empty(e_new, np.float32)
    x_new[new_pos_of_kept] = g.x[kept_old_idx]
    y_new[new_pos_of_kept] = g.y[kept_old_idx]
    val_new[new_pos_of_kept] = g.val[kept_old_idx]
    x_new[new_pos_of_add] = add_dst.astype(np.int32)
    y_new[new_pos_of_add] = add_src.astype(np.int32)

    # ---- renormalize touched sources only (val is 1/outdeg of the source) -
    touched = np.unique(np.concatenate([add_src, remove_src]))
    changed = np.isin(y_new, touched) if touched.size else np.zeros(e_new, bool)
    if changed.any():
        # same formula as from_edges: float64 reciprocal, then float32 cast
        val_new[changed] = (1.0 / new_outdeg[y_new[changed]]).astype(np.float32)

    dangling = np.zeros(v_new, bool)
    dangling[:v_old] = g.dangling
    dangling[v_old:] = new_outdeg[v_old:] == 0
    if touched.size:
        dangling[touched] = new_outdeg[touched] == 0

    changed_dst = np.unique(np.concatenate(
        [x_new[changed].astype(np.int64), remove_dst]))
    merged = COOGraph(num_vertices=v_new, x=x_new, y=y_new, val=val_new,
                      dangling=dangling)
    info = EdgeMergeInfo(
        kept_old_idx=kept_old_idx, new_pos_of_kept=new_pos_of_kept,
        changed_mask=changed, touched_sources=touched,
        changed_dst=changed_dst, new_outdeg=new_outdeg,
        num_added=int(add_src.size), num_removed=int(remove_src.size))
    return merged, info


def quantize_values(val: np.ndarray, fmt: QFormat) -> np.ndarray:
    """Truncate edge values into ``fmt`` (raw uint32) — the elementwise body of
    ``COOGraph.quantized_val``, exposed so delta ingestion can requantize only
    the ``changed_mask`` slice instead of the whole stream."""
    raw = np.floor(np.clip(np.asarray(val, np.float64), 0.0, None) * fmt.scale)
    return np.minimum(raw, fmt.max_raw).astype(np.uint32)


@dataclasses.dataclass
class BlockedCOO:
    """2-D (dst_tile × src_tile) blocking of a COOGraph for the SpMV kernel.

    Edges are bucketed by (x // v_tile, y // v_tile); each bucket is padded to a
    whole number of ``packet`` edges.  Buckets are concatenated in dst-major order
    with a CSR-like ``block_starts`` index (in packets).  Inside a bucket indices
    are *local* to the tile, matching the kernel's tile addressing.
    """

    num_vertices: int
    v_tile: int
    packet: int
    n_dst: int
    n_src: int
    x_local: np.ndarray       # int32 [Ep]  (padded total edges)
    y_local: np.ndarray       # int32 [Ep]
    val: np.ndarray           # float32 [Ep]
    block_starts: np.ndarray  # int32 [n_dst*n_src + 1] in packets
    num_real_edges: int

    @property
    def num_packets(self) -> int:
        return int(self.block_starts[-1])

    @property
    def pad_overhead(self) -> float:
        tot = self.num_packets * self.packet
        return tot / max(1, self.num_real_edges)

    @property
    def index_dtype(self):
        """Block-local indices fit 16 bits whenever v_tile ≤ 65536 — a
        beyond-paper compression the 2-D blocking enables: the edge stream
        drops from 8 B to 4 B of indices per edge (halving the streaming
        bandwidth term of the SpMV kernel's bound)."""
        return np.uint16 if self.v_tile <= (1 << 16) else np.int32

    def packed_indices(self):
        """(x_local, y_local) in the narrowest dtype the tiling allows."""
        dt = self.index_dtype
        return self.x_local.astype(dt), self.y_local.astype(dt)

    def edge_stream_bytes(self, value_bits: int = 32) -> int:
        """HBM bytes of one full pass over the packed edge stream."""
        e = self.num_packets * self.packet
        idx = 2 if self.index_dtype == np.uint16 else 4
        return e * (2 * idx + value_bits // 8)

    @staticmethod
    def build(g: COOGraph, v_tile: int, packet: int) -> "BlockedCOO":
        v = g.num_vertices
        n_dst = (v + v_tile - 1) // v_tile
        n_src = (v + v_tile - 1) // v_tile
        bx = g.x // v_tile
        by = g.y // v_tile
        block_id = bx.astype(np.int64) * n_src + by
        order = np.argsort(block_id, kind="stable")
        xb, yb, vb, bid = g.x[order], g.y[order], g.val[order], block_id[order]
        counts = np.bincount(bid, minlength=n_dst * n_src)
        pad_counts = (counts + packet - 1) // packet * packet
        block_starts = np.zeros(n_dst * n_src + 1, np.int64)
        np.cumsum(pad_counts // packet, out=block_starts[1:])
        total = int(pad_counts.sum())
        x_local = np.zeros(total, np.int32)
        y_local = np.zeros(total, np.int32)
        val = np.zeros(total, np.float32)
        # scatter each block's edges into its padded slot
        src_off = np.zeros(n_dst * n_src + 1, np.int64)
        np.cumsum(counts, out=src_off[1:])
        dst_off = block_starts * packet
        for b in np.nonzero(counts)[0]:
            s0, s1 = src_off[b], src_off[b + 1]
            d0 = dst_off[b]
            n = s1 - s0
            x_local[d0:d0 + n] = xb[s0:s1] % v_tile
            y_local[d0:d0 + n] = yb[s0:s1] % v_tile
            val[d0:d0 + n] = vb[s0:s1]
        return BlockedCOO(
            num_vertices=v, v_tile=v_tile, packet=packet,
            n_dst=n_dst, n_src=n_src,
            x_local=x_local, y_local=y_local, val=val,
            block_starts=block_starts.astype(np.int32),
            num_real_edges=g.num_edges,
        )
