"""The paper's truncation quantizer lifted to LM weights and activations
(counterpart of ``repro.core.quantization``).

- ``quantize_weights``: per-channel symmetric int8 (or narrower) weight
  quantization for the serving matmul (``kernels/fixed_matmul``).  ``q`` and
  ``scale`` are bit-identical to the reference: f32 divide, ``trunc``, clip,
  int8.
- ``truncate_to_grid``: the exact paper quantizer (toward zero, 2^-f grid).

``ErrorFeedbackQuantizer`` (gradient compression) comes with the training
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantizedTensor", "quantize_weights", "dequantize", "truncate_to_grid"]


def truncate_to_grid(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """Signed truncation-toward-zero to the 2^-f grid (paper policy, signed ext)."""
    scale = float(1 << frac_bits)
    return torch.trunc(x * scale) / scale


class QuantizedTensor(NamedTuple):
    """Per-channel symmetric quantized tensor: w ≈ q * scale[None, :]."""

    q: torch.Tensor       # int8 [in, out]
    scale: torch.Tensor   # f32 [out]


def quantize_weights(w: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Per-output-channel symmetric quantization with truncation rounding."""
    maxq = float(2 ** (bits - 1) - 1)
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / maxq,
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.trunc(w / scale[None, :])
    q = q.clamp(-maxq - 1, maxq).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return qt.q.to(dtype) * qt.scale[None, :].to(dtype)
