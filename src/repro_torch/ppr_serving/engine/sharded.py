"""Mesh-sharded engines: the paper's multi-channel edge partitioning scaled
to an axis of a ``launch.mesh.Mesh`` (counterpart of
``repro.ppr_serving.engine.sharded``).

The host owns the partitioning (the CPU–FPGA synergy argument of arXiv
2004.13907): edges are bucketed by destination range once per topology
epoch (``core.spmv.partition_edges_by_dst``, the reference's host layout,
per prepared Q format too), and each bucket becomes the pad-free dst stream
of its shard's ``v_local`` rows (``kernels.dst_stream.build_dst_stream`` over
the bucket's edge arrays), uploaded to the shard's device.  Each iteration runs ``coo_spmv_kernel``
over every shard's stream (its plain version on the CPU), gathers the rows
on the controller and combines there.  Per-shard raw sums are exact and each
destination row lives on exactly one shard, so ``ShardedFixedEngine`` is
*bit-identical* to ``FixedEngine``; the float pair differs only by the
shards' summation order.

Delta ingestion re-buckets only the destination ranges a merge touched and
rebuilds those shards' streams (``refresh_partition_after_delta``), with a
full re-partition when the delta moves the ceil-division layout itself
(vertex growth changing ``ceil(V / n_shards)``) or an affected bucket
outgrows its padding.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.fixed_point import QFormat
from repro_torch.core.ppr import (
    make_ppr_sharded_fixed_step,
    make_ppr_sharded_float_step,
    personalization_matrix,
    personalization_matrix_fixed,
)
from repro_torch.core.spmv import partition_edges_by_dst, sharded_vertex_layout
from repro_torch.kernels.dst_stream import build_dst_stream
from repro_torch.ppr_serving.engine.base import WaveEngine, WavePlan, register_engine

__all__ = ["ShardedFloatEngine", "ShardedFixedEngine", "partition_topology",
           "partition_format", "refresh_partition_after_delta", "shard_operands"]


# ---------------------------------------------------------------------------
# partition state helpers — operate on a ShardedRegisteredGraph's buckets
# ---------------------------------------------------------------------------
def _rebuild_streams(rg, shards) -> None:
    """Build the dst streams of ``shards`` from their host buckets and upload
    what each old stream had uploaded, releasing the old uploads."""
    v_local, _ = sharded_vertex_layout(rg.num_vertices, rg.n_shards)
    streams = list(rg.shard_streams) or [None] * rg.n_shards
    for s in shards:
        uploaded = streams[s].release() if streams[s] is not None else []
        streams[s] = st = build_dst_stream(
            (rg._host_x[s], rg._host_y[s], rg._host_val[s], v_local))
        dev = rg.shard_devices[s]
        for key in uploaded:
            if key[0] == "topology":
                st.topology(dev)
            else:
                st.values(dev, key[2])
    rg.shard_streams = streams


def partition_topology(rg) -> None:
    """(Re-)bucket the *unpadded* edge stream by destination range (pad edges
    would only inflate shard 0 with zero slots the per-shard padding already
    provides), re-partition every prepared Q format through the same
    dtype-preserving partitioner, and rebuild every shard's stream."""
    s = rg.n_shards
    sx, sy, sval = partition_edges_by_dst(
        rg.source.x, rg.source.y, rg.source.val,
        rg.num_vertices, s, packet=rg.packet)
    rg._host_x = sx.reshape(s, -1)
    rg._host_y = sy.reshape(s, -1)
    rg._host_val = sval.reshape(s, -1)
    rg._sharded_quantized.clear()
    for fmt in tuple(rg._sharded_quant_host):
        _, _, sq = partition_edges_by_dst(
            rg.source.x, rg.source.y, rg._quantize_host(fmt),
            rg.num_vertices, s, packet=rg.packet)
        rg._sharded_quant_host[fmt] = sq.reshape(s, -1)
    _rebuild_streams(rg, range(s))


def shard_operands(rg, fmt: Optional[QFormat] = None) -> List:
    """One ``(StreamTopology, values)`` pair per shard, on the shard's device
    (float32 values, or int32 raw bits of ``fmt``; each uploaded once)."""
    return [(st.topology(dev), st.values(dev, fmt))
            for st, dev in zip(rg.shard_streams, rg.shard_devices)]


def partition_format(rg, fmt: QFormat) -> torch.Tensor:
    """Partition the raw uint32 host values of ``fmt`` (cached), upload each
    shard's raw int32 stream values to its device, and return the raw edge
    shard values in the partitioned layout, [S·max_e]: a host view, int32
    holding the uint32 bits, copied nowhere (``ShardedRegisteredGraph.
    sharded_quantized`` puts them on the controller when asked).

    A stream's raw values are ``quantize_values`` of its float32 values per
    edge, the function that filled the host buckets, so they are the bucket's
    raw bits in stream order."""
    if fmt not in rg._sharded_quant_host:
        _, _, sval = partition_edges_by_dst(
            rg.source.x, rg.source.y, rg._quantize_host(fmt),
            rg.num_vertices, rg.n_shards, packet=rg.packet)
        rg._sharded_quant_host[fmt] = sval.reshape(rg.n_shards, -1)
    shard_operands(rg, fmt)
    raw = np.ascontiguousarray(rg._sharded_quant_host[fmt], np.uint32).reshape(-1)
    return torch.from_numpy(raw.view(np.int32))


def refresh_partition_after_delta(rg, info) -> None:
    """Delta ingestion on a meshed graph: re-partition only the destination
    buckets that own a changed or removed edge, and rebuild only their
    streams.

    Falls back to a full re-partition when the delta moves the bucket
    geometry itself (vertex growth changing ``ceil(V / n_shards)``) or an
    affected bucket outgrows the current per-shard padding.  Idempotent per
    delta: both family members are armed on most graphs and each calls in."""
    if not rg._sharded_stale:
        return
    rg._sharded_stale = False
    t0 = time.perf_counter()
    old_v_local = rg._pre_delta_v_local
    v_local, _ = sharded_vertex_layout(rg.num_vertices, rg.n_shards)
    max_e = rg._host_x.shape[1]
    shard_of = rg.source.x // v_local
    counts = np.bincount(shard_of, minlength=rg.n_shards)
    affected = np.unique(info.changed_dst // v_local).astype(np.int64)
    if v_local != old_v_local or counts[affected].max(initial=0) > max_e:
        partition_topology(rg)
        rg.last_refresh_shards = None
        rg.delta_timings["partition"] = time.perf_counter() - t0
        return
    for s in affected:
        m = shard_of == s
        n = int(counts[s])
        for host in (rg._host_x, rg._host_y, rg._host_val):
            host[s, :] = 0
        rg._host_x[s, :n] = rg.source.x[m] % v_local
        rg._host_y[s, :n] = rg.source.y[m]
        rg._host_val[s, :n] = rg.source.val[m]
        for fmt, hq in rg._sharded_quant_host.items():
            hq[s, :] = 0
            hq[s, :n] = rg._quantized_host[fmt][m]
    rg._sharded_quantized.clear()
    t1 = time.perf_counter()
    _rebuild_streams(rg, [int(s) for s in affected])
    rg.last_refresh_shards = [int(s) for s in affected]
    rg.delta_timings.update(partition=t1 - t0, streams=time.perf_counter() - t1)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
@register_engine
class ShardedFloatEngine(WaveEngine):
    """float32 iterations whose SpMV streams mesh-partitioned edge shards."""

    key = "sharded_float"
    family = "sharded"
    fixed = False
    needs_mesh = True

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        shard_operands(rg)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None, trace_hook=None) -> WavePlan:
        body = make_ppr_sharded_float_step(rg.mesh, rg.axis,
                                           rg.num_vertices, alpha)
        shards = shard_operands(rg)
        dangling = rg.dangling
        num_vertices = rg.num_vertices

        def step(Vmat, P):
            return body(shards, dangling, Vmat, P)

        return WavePlan(
            engine=self.key, fixed=False, scale=None,
            initial=lambda pers: personalization_matrix(num_vertices, pers),
            step=step,
            iterate=self._make_iterate(iterations, convergence, False, None,
                                       trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()
        refresh_partition_after_delta(rg, info)


@register_engine
class ShardedFixedEngine(WaveEngine):
    """Bit-exact reduced-precision iterations over mesh-partitioned raw
    shards — bit-identical to ``FixedEngine`` on any V and shard count."""

    key = "sharded_fixed"
    family = "sharded"
    fixed = True
    needs_mesh = True

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        if fmt is not None:
            partition_format(rg, fmt)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None, trace_hook=None) -> WavePlan:
        if fmt is None:
            raise ValueError(f"{self.key!r} engine needs a concrete Q format")
        self.prepare(rg, fmt)
        body = make_ppr_sharded_fixed_step(fmt, rg.mesh, rg.axis,
                                           rg.num_vertices, alpha)
        shards = shard_operands(rg, fmt)
        dangling = rg.dangling
        num_vertices = rg.num_vertices

        def step(Vmat, P):
            return body(shards, dangling, Vmat, P)

        return WavePlan(
            engine=self.key, fixed=True, scale=fmt.scale,
            initial=lambda pers: personalization_matrix_fixed(
                num_vertices, pers, fmt),
            step=step,
            iterate=self._make_iterate(iterations, convergence, True, fmt.scale,
                                       trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()
        refresh_partition_after_delta(rg, info)
