"""Distributed-optimization collectives (counterpart of
``repro.distributed.collectives``).

``compressed_psum``: the paper's truncation quantizer applied to the
data-parallel gradient all-reduce, with error feedback:

  on each device:  c = trunc_grid(g + r);  r' = (g + r) - c
  all-reduce:      G = Σ c / n

Wire bytes drop from 32-bit to (1 + int_bits + frac_bits) per element; the
residual r carries the truncation error into the next step, so the long-run
update is unbiased (error-feedback SGD).

Each rank calls these on its own tensors, as the reference's run inside
``shard_map``: the all-reduce is ``torch.distributed.all_reduce`` (SUM, then
÷ n, as ``pmean``) over the group of one mesh axis, ``mesh.get_group(axis)``
of a ``DeviceMesh`` (gloo on the CPU, NCCL on the card).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quantization import truncate_to_grid

__all__ = ["compressed_psum", "make_compressed_grad_allreduce", "collective_bytes_saved"]


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, axis: str, frac_bits: int = 12,
                    *, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized all-reduce of one tensor over ``mesh``'s ``axis`` with error
    feedback.  Returns (mean-reduced gradient, new residual)."""
    corrected = g + residual
    q = truncate_to_grid(corrected, frac_bits)
    new_residual = corrected - q
    group = mesh.get_group(axis)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q / dist.get_world_size(group), new_residual


def make_compressed_grad_allreduce(mesh, axis: str, frac_bits: int = 12):
    """Gradient all-reduce over a dict of tensors with per-tensor error
    feedback: ``allreduce(grads, residuals) → (reduced, new residuals)``."""

    def allreduce(grads: Dict[str, torch.Tensor], residuals: Dict[str, torch.Tensor]):
        red, res = {}, {}
        for k, g in grads.items():
            red[k], res[k] = compressed_psum(g, residuals[k], axis, frac_bits, mesh=mesh)
        return red, res

    return allreduce


def collective_bytes_saved(n_params: int, frac_bits: int, int_bits: int = 2) -> float:
    """Wire-format reduction factor vs f32 ring all-reduce (for napkin math)."""
    return 32.0 / (1 + int_bits + frac_bits)
