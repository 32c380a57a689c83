"""COO graph container + packetization (paper §3, §4.1).

Counterpart of ``repro.core.coo``: host numpy, copied so that the port
builds array-equal layouts.  ``merge_edge_delta`` comes with the delta slice.

The paper streams the graph as three equal arrays (x=dst, y=src, val) in packets of
B edges.  The matrix is additionally 2-D blocked by (dst_tile, src_tile): the
reference's TPU kernel keeps one P_t source slice and one accumulator slice in
VMEM, and the port's CUDA kernel keeps the dst accumulator tile in shared memory
(see ``repro_torch.kernels.coo_spmv``).

Padding discipline: sentinel edges have val=0 and x=y=0 inside their block, so they
contribute nothing while keeping every block a whole number of packets.
"""
from __future__ import annotations

import dataclasses

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
