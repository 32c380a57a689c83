"""Streaming COO SpMM (the paper's §4.1.1) — CUDA kernel and its plain version.

Replaces ``src/repro/kernels/coo_spmv.py::coo_spmv_pallas`` (bodies
``_kernel_float``/``_kernel_fixed``, limb multiply ``_fixed_mul_u32``).  The
kernel is ``csrc/coo_spmv.cu``; its header says how it maps the TPU design.

Bound on the H100: memory bytes — 2 + 2 + 4 B per real edge and 4 B per pad
slot (its value only), P once and the output once.  The design keeps each dst
tile's accumulator in shared memory (one CUDA block per dst tile, written
once) and skips the index loads, gathers and atomics of pad slots, so the
padding costs its value reads and the walk over its slots.

``coo_spmv_kernel`` launches the kernel for CUDA tensors and raises on any
operand the kernel does not take; for CPU tensors it runs ``coo_spmv_plain``,
the same function in plain PyTorch.  ``coo_spmv_kernel.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.fixed_point import QFormat
from repro_torch.core.spmv import spmv_fixed, spmv_float
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand

__all__ = ["coo_spmv_kernel", "coo_spmv_plain", "launch_geometry"]

# shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


def launch_geometry(v_tile: int, k: int, extra_words: int = 0):
    """(threads, dynamic shared bytes) for a v_tile x K shared accumulator.

    Threads are a multiple of K (each thread owns one column); raises when the
    accumulator does not fit in a block's shared memory."""
    if not 1 <= k <= 1024:
        raise ValueError(f"K={k} columns: the kernels take 1 <= K <= 1024")
    smem = 4 * (v_tile * k + extra_words)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"v_tile={v_tile} x K={k} accumulator needs {smem} B of "
                         f"shared memory, above the {MAX_SMEM_BYTES} B a block has")
    return k * max(1, 256 // k), smem


def _local(idx: torch.Tensor) -> torch.Tensor:
    """16-bit tile-local indices (int16 holding uint16 bits) → int64."""
    return idx.to(torch.int64) & 0xFFFF


def coo_spmv_plain(x_local, y_local, val, p, dst_start, packet_src, *,
                   v_tile: int, packet: int, n_dst: int,
                   frac_bits: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: out [n_dst·v_tile, K]."""
    counts = (dst_start[1:] - dst_start[:-1]).to(torch.int64)
    packet_dst = torch.repeat_interleave(
        torch.arange(n_dst, device=p.device), counts)
    xg = (packet_dst[:, None] * v_tile + _local(x_local)).reshape(-1)
    yg = (packet_src.to(torch.int64)[:, None] * v_tile + _local(y_local)).reshape(-1)
    rows = n_dst * v_tile
    if frac_bits is None:
        return spmv_float(xg, yg, val.reshape(-1), p, rows)
    return spmv_fixed(xg, yg, val.reshape(-1), p, rows, QFormat(1, frac_bits))


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.coo_spmv_launch.argtypes = [vp] * 7 + [i] * 7 + [vp]
    lib.coo_spmv_launch.restype = i
    lib.coo_spmv_error_string.argtypes = [i]
    lib.coo_spmv_error_string.restype = ctypes.c_char_p


def coo_spmv_kernel(x_local, y_local, val, p, dst_start, packet_src, *,
                    v_tile: int, packet: int, n_dst: int,
                    frac_bits: Optional[int] = None) -> torch.Tensor:
    """out [n_dst·v_tile, K] = X·P over a BlockedCOO's packets.

    ``x_local``/``y_local`` [P, packet] int16 (uint16 tile-local bits);
    ``val`` [P, packet] float32, or int32 raw bits when ``frac_bits`` is set;
    ``p`` [n_src·v_tile, K] of the same domain; ``dst_start`` [n_dst+1] int32
    packet offsets per dst tile; ``packet_src`` [P] int32 src tile per packet.
    A dst tile with no packets comes back as zeros.
    """
    if p.device.type == "cpu":
        return coo_spmv_plain(x_local, y_local, val, p, dst_start, packet_src,
                              v_tile=v_tile, packet=packet, n_dst=n_dst,
                              frac_bits=frac_bits)
    fixed = frac_bits is not None
    if fixed and not 0 <= frac_bits < 32:
        raise ValueError(f"frac_bits={frac_bits} outside [0, 32)")
    if p.dim() != 2 or p.shape[0] % v_tile:
        raise ValueError(f"p must be [n_src*v_tile, K], got {tuple(p.shape)}")
    n_packets, k = int(packet_src.shape[0]), int(p.shape[1])
    dom = torch.int32 if fixed else torch.float32
    check_operand(p, "p", dom)
    check_operand(val, "val", dom, (n_packets, packet))
    check_operand(x_local, "x_local", torch.int16, (n_packets, packet))
    check_operand(y_local, "y_local", torch.int16, (n_packets, packet))
    check_operand(dst_start, "dst_start", torch.int32, (n_dst + 1,))
    check_operand(packet_src, "packet_src", torch.int32)
    threads, smem = launch_geometry(v_tile, k)
    out = torch.empty((n_dst * v_tile, k), dtype=p.dtype, device=p.device)
    if n_dst == 0:
        return out
    lib = _build.load("coo_spmv", _declare)
    with torch.cuda.device(p.device):
        status = lib.coo_spmv_launch(
            x_local.data_ptr(), y_local.data_ptr(), val.data_ptr(), p.data_ptr(),
            dst_start.data_ptr(), packet_src.data_ptr(), out.data_ptr(),
            n_dst, v_tile, packet, k, frac_bits if fixed else -1, threads, smem,
            torch.cuda.current_stream(p.device).cuda_stream)
    if status:
        raise RuntimeError(f"coo_spmv launch failed: "
                           f"{lib.coo_spmv_error_string(status).decode()}")
    coo_spmv_kernel.launches += 1
    return out


coo_spmv_kernel.launches = 0
