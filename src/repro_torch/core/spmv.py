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

The sharded builders come with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Optional

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
