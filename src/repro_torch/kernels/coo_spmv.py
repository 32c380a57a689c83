"""Streaming COO SpMM (the paper's §4.1.1) — CUDA kernel and its plain version.

Replaces ``src/repro/kernels/coo_spmv.py::coo_spmv_pallas`` (bodies
``_kernel_float``/``_kernel_fixed``, limb multiply ``_fixed_mul_u32``).  The
kernel is ``csrc/coo_spmv.cu`` over ``csrc/dst_stream.cuh``; it reads the
pad-free dst stream of ``kernels/dst_stream.py`` (the same edges as the
reference's packets, without their pad slots).

Bound on the H100: memory bytes — 4 + 4 B per edge (col, val), ``row_ptr``,
P once and the output once; the P-row gathers hit the 50 MB L2.  The design
balances work by edges (one warp a slice of the stream, about a thousand
CTAs whatever the skew), sums rows in registers and shuffles, keeps four
gathers in flight a lane, and closes rows cut by a slice boundary in a
second, row-parallel launch.

``coo_spmv_kernel`` takes the stream as a ``StreamTopology``
(``DstStream.topology``), so its slice schedule always comes with the slice
size it was cut at.  It launches the kernels for CUDA tensors and raises on
any operand they do not take; for CPU tensors it runs ``coo_spmv_plain``, the
same function in plain PyTorch.  ``coo_spmv_kernel.launches`` counts calls
that launched (two device launches each).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.fixed_point import QFormat
from repro_torch.core.spmv import spmv_fixed, spmv_float
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand

__all__ = ["coo_spmv_kernel", "coo_spmv_plain", "launch_geometry", "check_stream",
           "stream_rows", "WARPS_PER_CTA", "MAX_SLICE_EDGES"]

# the CTA and shared-memory layout csrc/dst_stream.cuh is compiled with
_CUH = _build.csrc_constants("dst_stream.cuh")
WARPS_PER_CTA = _CUH["kWarps"]          # one stream slice a warp
MAX_SLICE_EDGES = 1024     # a CTA stages WARPS_PER_CTA slices in shared memory
THREADS = 32 * WARPS_PER_CTA
# shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


def launch_geometry(k: int, slice_edges: int):
    """(threads, dynamic shared bytes, vector width) of the stream SpMV.

    A CTA stages ``WARPS_PER_CTA`` slices in shared memory: each slice's
    col and val, its rows' starts and ids, and its slots' partials
    (``warp_words`` in ``csrc/dst_stream.cuh``); a lane loads 4 columns of a
    P row at once when K % 4 == 0, else 1.  Raises on K outside [1, 1024]
    and on slices the shared memory does not take."""
    if not 1 <= k <= 1024:
        raise ValueError(f"K={k} columns: the kernels take 1 <= K <= 1024")
    warp_words = _CUH["kWordsPerSliceEdge"] * slice_edges + _CUH["kWarpFixedWords"]
    smem = 4 * WARPS_PER_CTA * warp_words
    if slice_edges % 32 or not 32 <= slice_edges <= MAX_SLICE_EDGES or smem > MAX_SMEM_BYTES:
        raise ValueError(f"slice_edges={slice_edges} stages {smem} B in shared memory: "
                         f"the kernels take multiples of 32 in [32, {MAX_SLICE_EDGES}]")
    return THREADS, smem, 4 if k % 4 == 0 else 1


def check_stream(topo, val, p, dom) -> int:
    """Raise unless ``topo`` (a ``StreamTopology``), its ``val`` and ``p``
    are operands the stream kernels take; returns the vector width.

    The slice schedule must span the stream at ``topo.slice_edges`` and
    ``p`` must hold every src row the stream reads."""
    if p.dim() != 2:
        raise ValueError(f"p must be [V, K], got {tuple(p.shape)}")
    if p.shape[0] < topo.src_rows:
        raise ValueError(f"p has {p.shape[0]} rows; the stream reads src rows up to "
                         f"{topo.src_rows - 1}")
    _, _, vec = launch_geometry(int(p.shape[1]), topo.slice_edges)
    n_edges = topo.num_edges
    check_operand(p, "p", dom, align=4 * vec)
    check_operand(val, "val", dom, (n_edges,))
    check_operand(topo.col, "col", torch.int32, (n_edges,))
    check_operand(topo.row_ptr, "row_ptr", torch.int32, dims=1)
    check_operand(topo.nz_rows, "nz_rows", torch.int32, dims=1)
    check_operand(topo.slice_row, "slice_row", torch.int32,
                  (max(1, -(-n_edges // topo.slice_edges)) + 1,))
    return vec


def stream_rows(row_ptr: torch.Tensor) -> torch.Tensor:
    """[E] int64 dst row of every edge of a stream."""
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(torch.arange(counts.shape[0], device=row_ptr.device),
                                   counts)


def coo_spmv_plain(topo, val, p, *, frac_bits: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: out [rows, K]."""
    rows = stream_rows(topo.row_ptr)
    if frac_bits is None:
        return spmv_float(rows, topo.col, val, p, topo.num_rows)
    return spmv_fixed(rows, topo.col, val, p, topo.num_rows, QFormat(1, frac_bits))


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.coo_spmv_launch.argtypes = [vp] * 8 + [i] * 8 + [vp]
    lib.coo_spmv_launch.restype = i
    lib.coo_spmv_error_string.argtypes = [i]
    lib.coo_spmv_error_string.restype = ctypes.c_char_p


def coo_spmv_kernel(topo, val, p, *, frac_bits: Optional[int] = None) -> torch.Tensor:
    """out [rows, K] = X·P over a dst stream.

    ``topo`` is the stream's ``StreamTopology`` on p's device (``row_ptr``
    [rows+1], ``col`` [E] src, the slice schedule and its ``slice_edges``),
    ``val`` [E] its values, float32 or int32 raw bits when ``frac_bits`` is
    set; ``p`` [*, K] of the value's domain, holding every src row.  A row
    with no edge comes back as zeros.
    """
    if p.device.type == "cpu":
        return coo_spmv_plain(topo, val, p, frac_bits=frac_bits)
    fixed = frac_bits is not None
    if fixed and not 0 <= frac_bits < 32:
        raise ValueError(f"frac_bits={frac_bits} outside [0, 32)")
    vec = check_stream(topo, val, p, torch.int32 if fixed else torch.float32)
    rows, n_edges, k = topo.num_rows, topo.num_edges, int(p.shape[1])
    out = torch.empty((rows, k), dtype=p.dtype, device=p.device)
    if rows <= 0:
        return out
    n_ctas = -(-topo.num_slices // WARPS_PER_CTA)
    carry = torch.empty((n_ctas, k), dtype=p.dtype, device=p.device)
    fix_ctas = min(-(-rows * (k // vec) // THREADS), 65_535)
    lib = _build.load("coo_spmv", _declare)
    with torch.cuda.device(p.device):
        status = lib.coo_spmv_launch(
            topo.row_ptr.data_ptr(), topo.col.data_ptr(), val.data_ptr(),
            topo.nz_rows.data_ptr(), topo.slice_row.data_ptr(), p.data_ptr(),
            out.data_ptr(), carry.data_ptr(), rows, n_edges, n_ctas, topo.slice_edges,
            k, frac_bits if fixed else -1, vec, fix_ctas,
            torch.cuda.current_stream(p.device).cuda_stream)
    if status:
        raise RuntimeError(f"coo_spmv launch failed: "
                           f"{lib.coo_spmv_error_string(status).decode()}")
    coo_spmv_kernel.launches += 1
    return out


coo_spmv_kernel.launches = 0
