"""Reduced-precision serving matmul — CUDA kernels and their plain version.

Replaces ``src/repro/kernels/fixed_matmul.py::quantized_matmul_pallas`` (body
``_mm_kernel``): ``(a @ w_q) * scale[None, :]`` with int8 per-output-channel
weights, float32 accumulation and the scale in the epilogue.  The kernels are
in ``csrc/fixed_matmul.cu``; its header says how they map the TPU design.
Each activation type has one kernel: bfloat16 runs on the tensor cores
(wgmma, TMA; the tile computed transposed so that the int8 weights, widened
to bf16 in registers, exactly, are wgmma's register operand), float32 on
the CUDA cores.  Both split K in a fixed order when the output
has too few 128 × 128 tiles to fill the card (``plan_splits``, given the
CTAs the card runs at once, ``cta_slots``): partials go to a float32
workspace and the last CTA of each tile folds them in split order, so a
call gives the same bits every time.

Bound on the H100: operations at prefill sizes (2·M·K·N over the bf16 tensor
cores or the float32 CUDA cores), bytes of the int8 weights at decode sizes.

``quantized_matmul_kernel`` launches the kernel for CUDA tensors and raises on
any operand it does not take; for CPU tensors it runs
``quantized_matmul_plain``, which is the oracle ``ref.quantized_matmul_ref``
(the kernel computes exactly that function).  ``quantized_matmul_kernel.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand
from repro_torch.kernels.ref import quantized_matmul_ref as quantized_matmul_plain

__all__ = ["cta_slots", "plan_splits", "quantized_matmul_kernel", "quantized_matmul_plain"]

# the tiles and k steps csrc/fixed_matmul.cu is compiled with
_CONST = _build.csrc_constants("fixed_matmul.cu")
TILE_M, TILE_N = _CONST["BM"], _CONST["BN"]
K_STEP = {torch.float32: _CONST["BK"], torch.bfloat16: _CONST["TC_BK"]}
MAX_SPLITS = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_splits(m: int, n: int, k: int, k_step: int, slots: int) -> int:
    """How many parts the kernels split K into for an [m, k] x [k, n] product.

    ``slots`` is the CTAs the card runs at once (``cta_slots``).  One when
    the output's ``TILE_M × TILE_N`` tiles already fill them.  Otherwise
    the s in [1, min(steps, MAX_SPLITS)] that minimises the waves of CTAs
    times the ``k_step`` steps each runs, plus s for the fold that reads s
    partial tiles (ties: fewer splits).  Split z runs the k steps
    [z·steps // s, (z+1)·steps // s): every split a whole, non-empty number
    of steps, K covered exactly."""
    tiles = _cdiv(m, TILE_M) * _cdiv(n, TILE_N)
    steps = _cdiv(k, k_step)
    if tiles >= slots or steps <= 1:
        return 1
    return min(range(1, min(steps, MAX_SPLITS) + 1),
               key=lambda s: (_cdiv(tiles * s, slots) * _cdiv(steps, s) + s, s))


@functools.lru_cache(maxsize=None)
def cta_slots(device: torch.device, bf16: bool) -> int:
    """The CTAs of the bf16 or the float32 kernel that ``device`` runs at
    once: its SMs times the CTAs an SM holds (the runtime's occupancy)."""
    lib = _build.load("fixed_matmul", _declare)
    with torch.cuda.device(device):
        resident = lib.quantized_matmul_resident(int(bf16))
    if resident < 1:
        raise RuntimeError(f"quantized_matmul occupancy query failed: "
                           f"{lib.quantized_matmul_error_string(-resident).decode()}")
    return torch.cuda.get_device_properties(device).multi_processor_count * resident


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.quantized_matmul_launch.argtypes = [vp] * 6 + [i] * 5 + [vp]
    lib.quantized_matmul_launch.restype = i
    lib.quantized_matmul_resident.argtypes = [i]
    lib.quantized_matmul_resident.restype = i
    lib.quantized_matmul_error_string.argtypes = [i]
    lib.quantized_matmul_error_string.restype = ctypes.c_char_p


def quantized_matmul_kernel(a: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                            *, bm: int = 128, bn: int = 128,
                            bk: int = 128) -> torch.Tensor:
    """out [M, N] f32 = (a [M, K] f32/bf16 @ w_q [K, N] int8) * scale [N] f32.

    ``bm``/``bn``/``bk`` keep the reference's contract: a shape they do not
    divide raises ``ValueError``.  They are not the CUDA tile."""
    m, kdim = a.shape
    n = w_q.shape[1]
    if m % bm or n % bn or kdim % bk:
        raise ValueError(f"shape ({m},{kdim},{n}) not divisible by tile ({bm},{bk},{bn})")
    if a.device.type == "cpu":
        return quantized_matmul_plain(a, w_q, scale)
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    check_operand(a, "a", a.dtype, (m, kdim), align=16)
    check_operand(w_q, "w_q", torch.int8, (kdim, n), align=16)
    check_operand(scale, "scale", torch.float32, (n,), align=16)
    if kdim % 8 or n % 8:
        raise ValueError(f"the kernel needs K % 8 == 0 and N % 8 == 0, got K={kdim}, N={n}")
    bf16 = a.dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if kdim == 0:
        return out.zero_()
    splits = plan_splits(m, n, kdim, K_STEP[a.dtype], cta_slots(a.device, bf16))
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else out)
    lib = _build.load("fixed_matmul", _declare)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device)
        tickets = _build.tickets("fixed_matmul", a.device, stream,
                                 _cdiv(m, TILE_M) * _cdiv(n, TILE_N))
        status = lib.quantized_matmul_launch(
            a.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(), m, n, kdim, splits, int(bf16),
            stream.cuda_stream)
    if status:
        raise RuntimeError(f"quantized_matmul launch failed: "
                           f"{lib.quantized_matmul_error_string(status).decode()}")
    quantized_matmul_kernel.launches += 1
    return out


quantized_matmul_kernel.launches = 0
