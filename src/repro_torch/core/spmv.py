"""Streaming COO SpMV/SpMM — the paper's §4.1.1 (counterpart of ``repro.core.spmv``).

All compute X @ P for X in COO (x=dst rows, y=src cols, val) and dense P [V, K]
(K = κ batched personalization vectors; K=1 recovers plain SpMV).

Paths
-----
1. ``spmv_float``   plain PyTorch float32: gather → multiply → ``index_add_``.
2. ``spmv_fixed``   bit-exact unsigned Qm.f on raw int32 bits: per-edge
                    truncating multiply, then an exact raw-domain sum that wraps
                    mod 2^32 like the reference's int32 ``segment_sum``.
3. ``spmv_kernel``  the hand-written CUDA kernel (``repro_torch.kernels.coo_spmv``)
                    over the 2-D ``BlockedCOO`` layout.
4. sharded          ``make_sharded_spmv`` (float) / ``make_sharded_spmv_fixed``
                    (raw bits) over a ``launch.mesh.Mesh``: edges partitioned by
                    dst range on the ceil-division layout of
                    ``sharded_vertex_layout`` (``partition_edges_by_dst``), each
                    shard's rows computed by the kernel over that shard's dst
                    stream on its own device from the full P, the rows gathered
                    on the controller — the paper's partitioning techniques
                    [18, 20], as the reference scales them to a mesh.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fixed_point import QFormat, wrap_u32


def spmv_float(x: torch.Tensor, y: torch.Tensor, val: torch.Tensor,
               p: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """out[i, k] = Σ_{e: x[e]=i} val[e] · p[y[e], k]   (float32).

    Padding edges (val=0) contribute nothing regardless of their x/y.
    """
    contrib = val[:, None] * p[y.long()]
    out = torch.zeros((num_vertices, p.shape[1]), dtype=contrib.dtype,
                      device=p.device)
    return out.index_add_(0, x.long(), contrib)


def spmv_fixed(x: torch.Tensor, y: torch.Tensor, val_raw: torch.Tensor,
               p_raw: torch.Tensor, num_vertices: int, fmt: QFormat) -> torch.Tensor:
    """Fixed-point SpMM on raw values (int32 tensors holding uint32 bits).

    Each edge product truncates to the format; the aggregation is an exact
    int64 sum wrapped to 32 bits — the reference's int32 sum mod 2^32.
    """
    prod = fmt.mul(val_raw[:, None], p_raw[y.long()]).to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros((num_vertices, p_raw.shape[1]), dtype=torch.int64,
                      device=p_raw.device)
    acc.index_add_(0, x.long(), prod)
    return wrap_u32(acc)


def spmv_kernel(blocked, p: torch.Tensor, *,
                fmt: Optional[QFormat] = None) -> torch.Tensor:
    """SpMM through the CUDA kernel over ``blocked`` (a ``BlockedCOO``).

    Counterpart of ``repro.core.spmv.spmv_pallas``.  ``p`` is [n_src·v_tile, K]
    (``kernels.ops.pad_p_for_blocks``); on a CPU tensor the kernel's plain
    PyTorch version runs instead.
    """
    from repro_torch.kernels import ops as kops

    return kops.coo_spmv(blocked, p, fmt=fmt)


# ----------------------------------------------------------------------------
# 4. sharded path (graph partitioned by destination range)
# ----------------------------------------------------------------------------
def sharded_vertex_layout(num_vertices: int, n_shards: int) -> tuple:
    """(v_local, v_padded) of the ceil-division dst layout shared by the
    partitioner and every sharded SpMV: each shard owns ``v_local =
    ceil(V / n_shards)`` destination rows, the concatenated output covers
    ``v_padded = n_shards · v_local ≥ V`` rows, and the ``v_padded − V``
    phantom rows of the last shard receive no edges (they are cut away
    before anything downstream sees them)."""
    v_local = -(-num_vertices // n_shards)
    return v_local, n_shards * v_local


def _gather_shards(parts: List[torch.Tensor], controller: torch.device,
                   num_vertices: int) -> torch.Tensor:
    """The shards' [v_local, K] rows, moved to the controller in shard order,
    concatenated and cut to ``num_vertices`` rows."""
    return torch.cat([x.to(controller) for x in parts])[:num_vertices]


def _make_sharded(mesh, axis: str, num_vertices: int, frac_bits: Optional[int]):
    devices = mesh.axis_devices(axis)
    controller = mesh.controller

    def spmv(shards: Sequence[Tuple], p: torch.Tensor) -> torch.Tensor:
        import repro_torch.kernels.coo_spmv as kernel   # the kernels import core
        if len(shards) != len(devices):
            raise ValueError(f"{len(shards)} shard streams for {len(devices)} "
                             f"devices along {axis!r}")
        replicas = {}
        parts = []
        for (topo, val), dev in zip(shards, devices):
            if dev not in replicas:
                replicas[dev] = p.to(dev)
            parts.append(kernel.coo_spmv_kernel(topo, val, replicas[dev],
                                                frac_bits=frac_bits))
        return _gather_shards(parts, controller, num_vertices)

    return spmv


def make_sharded_spmv(mesh, axis: str, num_vertices: int):
    """SpMV over edges pre-partitioned by dst into ``mesh.shape[axis]`` shards.

    The returned ``spmv(shards, p)`` takes one ``(StreamTopology, values)``
    pair per shard — the dst stream of that shard's ``v_local`` rows with
    global src columns, on the shard's device (``mesh.axis_devices(axis)``)
    — and the full P [V, K] on the controller.  P is copied once to each
    device that holds a shard; each shard's rows are ``coo_spmv_kernel`` over
    its stream (its plain version on CPU tensors); the rows are gathered on
    the controller and cut to ``num_vertices`` (the ceil-division layout of
    ``sharded_vertex_layout``, so any V works on any shard count).  Per
    iteration that moves P to every other card and V·K·4 bytes back — the
    reference's all-gather of P, here from the controller.
    """
    return _make_sharded(mesh, axis, num_vertices, None)


def make_sharded_spmv_fixed(mesh, axis: str, num_vertices: int, fmt: QFormat):
    """Sharded counterpart of ``spmv_fixed``: raw int32 bits, truncating
    ``fmt`` multiplies per edge, exact raw-domain sums per shard.

    Integer sums are exact and order-independent and each destination row
    lives on exactly one shard, so the gathered result is *bit-identical* to
    single-device ``spmv_fixed``.
    """
    return _make_sharded(mesh, axis, num_vertices, fmt.frac_bits)


def partition_edges_by_dst(x, y, val, num_vertices: int, n_shards: int,
                           packet: int = 256):
    """Host-side: bucket edges by dst range and pad each shard to equal length.

    Ranges are ``ceil(num_vertices / n_shards)`` wide — ``sharded_vertex_layout``
    — so when num_vertices does not divide evenly the remainder vertices land
    in the (short) last shard.  Returns flat ``(x_local, y, val)`` of
    ``n_shards`` rows of ``max_e`` slots each (``max_e`` the largest bucket
    rounded up to ``packet``, at least ``packet``); x is local to the shard's
    dst range.  ``val``'s dtype is kept (float32 edge weights and raw uint32
    quantized values partition through the same code); pad slots carry
    val = 0, which contributes nothing in either domain.
    """
    v_local, _ = sharded_vertex_layout(num_vertices, n_shards)
    shard_of = np.asarray(x) // v_local
    shards = []
    max_e = 0
    for s in range(n_shards):
        m = shard_of == s
        xs = np.asarray(x)[m] % v_local
        ys = np.asarray(y)[m]
        vs = np.asarray(val)[m]
        shards.append((xs, ys, vs))
        max_e = max(max_e, xs.shape[0])
    max_e = max(packet, (max_e + packet - 1) // packet * packet)
    X = np.zeros((n_shards, max_e), np.int32)
    Y = np.zeros((n_shards, max_e), np.int32)
    V = np.zeros((n_shards, max_e), np.asarray(val).dtype)
    for s, (xs, ys, vs) in enumerate(shards):
        X[s, : xs.shape[0]] = xs
        Y[s, : ys.shape[0]] = ys
        V[s, : vs.shape[0]] = vs
    return X.reshape(-1), Y.reshape(-1), V.reshape(-1)
