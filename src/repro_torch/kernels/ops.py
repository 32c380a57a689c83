"""Public wrappers around the kernels (counterpart of ``repro.kernels.ops``).

``coo_spmv`` does the host-side packet→block metadata prep and the device
upload of the packed stream (once per graph, device and format, cached on the
``BlockedCOO``) and the empty-dst-block masking.  ``quantized_matmul`` is the
reduced-precision serving matmul (``fixed_matmul.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.coo import BlockedCOO, quantize_values
from repro_torch.core.fixed_point import QFormat
from repro_torch.kernels.coo_spmv import coo_spmv_kernel
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


def dst_packet_offsets(blocked: BlockedCOO) -> np.ndarray:
    """[n_dst+1] int32: dst tile d owns packets [off[d], off[d+1]) — the
    CUDA kernel's per-block range (``BlockedCOO`` is dst-major)."""
    starts = blocked.block_starts.astype(np.int64)
    return starts[::blocked.n_src].astype(np.int32)


def spmv_operands(blocked: BlockedCOO, device, fmt: Optional[QFormat] = None):
    """Device operands of the packed stream for ``coo_spmv_kernel`` (and the
    empty-dst-tile mask), cached on ``blocked`` per device and format."""
    cache = blocked.__dict__.setdefault("_kernel_operands", {})
    key = (str(device), fmt)
    if key not in cache:
        meta = blocked.__dict__.get("_packet_meta")
        if meta is None:
            meta = packet_metadata(blocked)
            blocked._packet_meta = meta
        _, packet_src, _, touched = meta
        n, pk = packet_src.shape[0], blocked.packet
        if blocked.index_dtype != np.uint16:
            raise ValueError(f"v_tile={blocked.v_tile} needs 32-bit local "
                             f"indices; the kernel streams 16-bit ones")
        xp_, yp_ = blocked.packed_indices()
        if fmt is None:
            val = blocked.val
        else:
            val = quantize_values(blocked.val, fmt).view(np.int32)

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        cache[key] = dict(
            x_local=up(xp_.view(np.int16).reshape(n, pk)),
            y_local=up(yp_.view(np.int16).reshape(n, pk)),
            val=up(val.reshape(n, pk)),
            dst_start=up(dst_packet_offsets(blocked)),
            packet_src=up(packet_src),
            mask=up(np.repeat(touched, blocked.v_tile)))
    return cache[key]


def coo_spmv(blocked: BlockedCOO, p: torch.Tensor, *,
             fmt: Optional[QFormat] = None) -> torch.Tensor:
    """Streaming SpMM through the kernel.  p: [n_src·v_tile, K] (the caller
    pads, ``pad_p_for_blocks``).  fmt=None → float32; else p and the values
    are raw int32 bits."""
    ops = spmv_operands(blocked, p.device, fmt)
    out = coo_spmv_kernel(
        ops["x_local"], ops["y_local"], ops["val"], p, ops["dst_start"],
        ops["packet_src"], v_tile=blocked.v_tile, packet=blocked.packet,
        n_dst=blocked.n_dst, frac_bits=None if fmt is None else fmt.frac_bits)
    # dst blocks with zero packets are masked, as in the reference
    return torch.where(ops["mask"][:, None], out, torch.zeros_like(out))


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
