"""Reduced-precision serving matmul — CUDA kernel and its plain version.

Replaces ``src/repro/kernels/fixed_matmul.py::quantized_matmul_pallas`` (body
``_mm_kernel``): ``(a @ w_q) * scale[None, :]`` with int8 per-output-channel
weights, float32 accumulation and the scale in the epilogue.  The kernel is
``csrc/fixed_matmul.cu``; its header says how it maps the TPU design.

Bound on the H100: operations at prefill sizes (2·M·K·N on the float32 CUDA
cores), bytes of the int8 weights at decode sizes.  The kernel streams the
weights as one byte each and widens them in registers.

``quantized_matmul_kernel`` launches the kernel for CUDA tensors and raises on
any operand it does not take; for CPU tensors it runs
``quantized_matmul_plain``, which is the oracle ``ref.quantized_matmul_ref``
(the kernel computes exactly that function).  ``quantized_matmul_kernel.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand
from repro_torch.kernels.ref import quantized_matmul_ref as quantized_matmul_plain

__all__ = ["quantized_matmul_kernel", "quantized_matmul_plain"]


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.quantized_matmul_launch.argtypes = [vp] * 4 + [i] * 4 + [vp]
    lib.quantized_matmul_launch.restype = i
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
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load("fixed_matmul", _declare)
    with torch.cuda.device(a.device):
        status = lib.quantized_matmul_launch(
            a.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, kdim, int(a.dtype == torch.bfloat16),
            torch.cuda.current_stream(a.device).cuda_stream)
    if status:
        raise RuntimeError(f"quantized_matmul launch failed: "
                           f"{lib.quantized_matmul_error_string(status).decode()}")
    quantized_matmul_kernel.launches += 1
    return out


quantized_matmul_kernel.launches = 0
