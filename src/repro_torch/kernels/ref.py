"""Plain-PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``)."""
from __future__ import annotations

import math

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


def quantized_matmul_ref(a, w_q, scale) -> torch.Tensor:
    """Oracle for fixed_matmul: (a @ w_q) * scale, accumulated in f32."""
    acc = a.to(torch.float32) @ w_q.to(torch.float32)
    return acc * scale[None, :].to(torch.float32)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Oracle for the fused attention kernel: q/k/v [BH, S, d]."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    s = torch.where(mask[None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    # fully-masked rows → 0 output (kernel convention)
    any_valid = mask.any(dim=1)[None, :, None]
    out = torch.einsum("bqk,bkd->bqd", w, v.to(torch.float32))
    return torch.where(any_valid, out, 0.0).to(q.dtype)
