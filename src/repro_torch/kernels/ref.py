"""Plain-PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``).

The LM-stack oracles (``quantized_matmul_ref``, ``flash_attention_ref``) come
with the LM-stack slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.fixed_point import QFormat
from repro_torch.core.spmv import spmv_fixed, spmv_float


def coo_spmv_ref(x, y, val, p, num_vertices: int) -> torch.Tensor:
    """Dense-semantics oracle for the streaming SpMM (float path)."""
    return spmv_float(x, y, val, p, num_vertices)


def coo_spmv_fixed_ref(x, y, val_raw, p_raw, num_vertices: int,
                       fmt: QFormat) -> torch.Tensor:
    """Bit-exact fixed-point oracle (truncating multiply, exact raw add)."""
    return spmv_fixed(x, y, val_raw, p_raw, num_vertices, fmt)
