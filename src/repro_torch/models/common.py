"""Shared building blocks: norms, RoPE, activations, initialization and
pattern→segment compression (counterpart of ``repro.models.common``).

Every function keeps the reference's dtype discipline: norms and RoPE compute
in float32 and return the input's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "layernorm", "norm", "act_fn", "softcap", "rope",
           "dense_init", "find_segments"]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def act_fn(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap·tanh(x/cap)."""
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)                                    # [half]
    angles = positions[..., None].to(torch.float32) * freqs      # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                        # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------
def dense_init(shape: Sequence[int], in_dim: int, generator: torch.Generator,
               device=None) -> torch.Tensor:
    """N(0, 1/in_dim) float32, drawn from ``generator`` (the reference's
    distribution; not its bits — ``jax.random`` and torch differ)."""
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return w / math.sqrt(in_dim)


# ---------------------------------------------------------------------------
# layer-pattern → (group, repeats) segments
# ---------------------------------------------------------------------------
def find_segments(pattern: Tuple[int, ...],
                  max_period: int = 8) -> List[Tuple[Tuple[int, ...], int]]:
    """Greedy compression of the per-layer pattern into periodic segments —
    the layout of the reference's stacked parameters and caches.

    gemma2  (4096,0)*23              → [((4096,0), 23)]
    gemma3  ((1024,)*5+(0,))*5+(1024,)*4 → [((1024,)*5+(0,), 5), ((1024,), 4)]
    uniform (0,)*L                   → [((0,), L)]
    """
    segs: List[Tuple[Tuple[int, ...], int]] = []
    i, n = 0, len(pattern)
    while i < n:
        best_p, best_r = 1, 1
        for p in range(1, min(max_period, n - i) + 1):
            group = pattern[i: i + p]
            r = 1
            while pattern[i + r * p: i + (r + 1) * p] == group:
                r += 1
            if p * r > best_p * best_r:
                best_p, best_r = p, r
        segs.append((pattern[i: i + best_p], best_r))
        i += best_p * best_r
    return segs
