"""Public wrappers around the kernels (counterpart of ``repro.kernels.ops``).

``coo_spmv`` turns a ``BlockedCOO``'s packets into the pad-free dst stream
(``kernels/dst_stream.py``, built once per graph and cached on the
``BlockedCOO``) and uploads it once per device and format; an empty dst row
comes back as 0 from the kernel itself.  ``quantized_matmul`` is the
reduced-precision serving matmul (``fixed_matmul.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.coo import BlockedCOO
from repro_torch.core.fixed_point import QFormat
from repro_torch.kernels.coo_spmv import coo_spmv_kernel
from repro_torch.kernels.dst_stream import DstStream, build_dst_stream
from repro_torch.kernels.fixed_matmul import quantized_matmul_kernel


def packet_metadata(blocked: BlockedCOO):
    """packet→(dst, src, first-of-dst, dst-touched) maps (host-side, O(E))."""
    starts = blocked.block_starts.astype(np.int64)
    n_dst, n_src = blocked.n_dst, blocked.n_src
    counts = np.diff(starts)                       # packets per (dst,src) block
    block_ids = np.nonzero(counts)[0]
    reps = counts[block_ids]
    packet_block = np.repeat(block_ids, reps)      # [num_packets]
    packet_dst = (packet_block // n_src).astype(np.int32)
    packet_src = (packet_block % n_src).astype(np.int32)
    first = np.zeros_like(packet_dst)
    if packet_dst.shape[0]:
        first[0] = 1
        first[1:] = (packet_dst[1:] != packet_dst[:-1]).astype(np.int32)
    touched = np.zeros(n_dst, bool)
    touched[np.unique(packet_dst)] = True
    return packet_dst, packet_src, first.astype(np.int32), touched


def dst_stream(blocked: BlockedCOO) -> DstStream:
    """``blocked``'s pad-free dst stream over its n_dst·v_tile rows (cached)."""
    stream = blocked.__dict__.get("_dst_stream")
    if stream is None:
        stream = blocked._dst_stream = build_dst_stream(blocked)
    return stream


def spmv_operands(blocked: BlockedCOO, device, fmt: Optional[QFormat] = None):
    """``(topology, val)``: ``blocked``'s dst stream on ``device`` for
    ``coo_spmv_kernel``, its ``StreamTopology`` and its values (float32, or
    int32 raw bits of ``fmt``), each uploaded once per device (and format)."""
    stream = dst_stream(blocked)
    return stream.topology(device), stream.values(device, fmt)


def coo_spmv(blocked: BlockedCOO, p: torch.Tensor, *,
             fmt: Optional[QFormat] = None) -> torch.Tensor:
    """Streaming SpMM through the kernel: out [n_dst·v_tile, K].  p is
    [n_src·v_tile, K] (the caller pads, ``pad_p_for_blocks``).  fmt=None →
    float32; else p and the values are raw int32 bits."""
    topo, val = spmv_operands(blocked, p.device, fmt)
    return coo_spmv_kernel(topo, val, p, frac_bits=None if fmt is None else fmt.frac_bits)


def pad_p_for_blocks(p: torch.Tensor, blocked: BlockedCOO) -> torch.Tensor:
    """Pad P [V, K] to [n_src·v_tile, K] for the kernel."""
    pad = blocked.n_src * blocked.v_tile - p.shape[0]
    if pad == 0:
        return p
    return torch.cat([p, p.new_zeros((pad, p.shape[1]))], dim=0)


def quantized_matmul(a, w_q, scale, **tiles) -> torch.Tensor:
    """Reduced-precision serving matmul (see fixed_matmul.py); ``tiles`` are
    the reference's ``bm``/``bn``/``bk`` divisibility contract."""
    return quantized_matmul_kernel(a, w_q, scale, **tiles)
