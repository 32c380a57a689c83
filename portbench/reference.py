"""The plain reference: Personalized PageRank by eq. (1) of the paper, in
plain PyTorch, from raw ``src -> dst`` edges.

It imports nothing of the port and takes nothing the port has made: the
transition values, the dangling set, the fixed-point constants and the
top-K are worked out here again from the edges.

    P_{t+1} = a X P_t + a/|V| (d^T P_t) 1 + (1 - a) Vbar,    P_0 = Vbar

with X[dst, src] = 1/outdeg(src), d the dangling (out-degree 0) vertices and
Vbar one one-hot column per personalization vertex.

Fixed point (unsigned Qm.f, the paper's datapath): an edge's value is its
float32 transition probability truncated to the grid; every product keeps
the low 32 bits of (a*b) >> f; sums wrap mod 2**32; the three terms of the
combine add with saturation at the format's largest value; the constants
are int(c * 2**f) of a, 1 - a and a/|V| in float64.  Integers are exact
here: every product is formed in int64 and stays below 2**62 for f <= 30.

Top-K: the k highest per column with the column's own vertex left out,
equal values ranked by ascending vertex id.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = (1 << 32) - 1


class RefGraph:
    """X in COO on ``device``, with the out-degrees and the dangling set."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, num_vertices: int,
                 device="cpu"):
        self.num_vertices = int(num_vertices)
        self.device = torch.device(device)
        self.y = torch.as_tensor(np.asarray(src, np.int64), device=self.device)
        self.x = torch.as_tensor(np.asarray(dst, np.int64), device=self.device)
        outdeg = torch.bincount(self.y, minlength=self.num_vertices)
        self.dangling = torch.nonzero(outdeg == 0).squeeze(1)
        self.inv_outdeg = 1.0 / outdeg[self.y].to(torch.float64)   # [E]

    @property
    def num_edges(self) -> int:
        return int(self.x.shape[0])

    def values_raw(self, frac_bits: int, max_raw: int) -> torch.Tensor:
        """[E] int64: the float32 transition value truncated into Q?.f."""
        v32 = self.inv_outdeg.to(torch.float32).to(torch.float64)
        raw = torch.floor(v32 * float(1 << frac_bits))
        return torch.clamp(raw, max=float(max_raw)).to(torch.int64)


def _onehot(num_vertices: int, pers: torch.Tensor, value, dtype) -> torch.Tensor:
    k = pers.shape[0]
    v = torch.zeros((num_vertices, k), dtype=dtype, device=pers.device)
    v[pers, torch.arange(k, device=pers.device)] = value
    return v


def ppr_fixed(g: RefGraph, pers: np.ndarray, int_bits: int, frac_bits: int,
              alpha: float, iterations: int) -> torch.Tensor:
    """[V, K] int64 raw Q<int_bits>.<frac_bits> states after ``iterations``."""
    if frac_bits > 30 or int_bits + frac_bits > 32:
        raise ValueError("the int64 reference holds Q formats with f <= 30 "
                         "and at most 32 bits")
    f = frac_bits
    scale = 1 << f
    max_raw = (1 << (int_bits + f)) - 1
    a_raw = int(alpha * scale)
    oma_raw = int((1.0 - alpha) * scale)
    aov_raw = int(alpha / g.num_vertices * scale)
    p = torch.as_tensor(np.asarray(pers, np.int64), device=g.device)
    vbar = _onehot(g.num_vertices, p, scale, torch.int64)
    restart = ((oma_raw * vbar) >> f) & MASK32
    val = g.values_raw(f, max_raw)[:, None]
    P = vbar
    for _ in range(iterations):
        prod = ((val * P[g.y]) >> f) & MASK32
        xp = torch.zeros_like(P).index_add_(0, g.x, prod) & MASK32
        dm = P[g.dangling].sum(0) & MASK32
        s = ((a_raw * xp) >> f & MASK32) + ((aov_raw * dm) >> f & MASK32)[None, :]
        P = torch.clamp(torch.clamp(s, max=max_raw) + restart, max=max_raw)
    return P


def ppr_float(g: RefGraph, pers: np.ndarray, alpha: float, iterations: int,
              dtype=torch.float64) -> torch.Tensor:
    """[V, K] states after ``iterations``, every operation in ``dtype``."""
    p = torch.as_tensor(np.asarray(pers, np.int64), device=g.device)
    vbar = _onehot(g.num_vertices, p, 1.0, dtype)
    val = g.inv_outdeg.to(dtype)[:, None]
    P = vbar
    for _ in range(iterations):
        xp = torch.zeros_like(P).index_add_(0, g.x, val * P[g.y])
        dm = P[g.dangling].sum(0)
        P = alpha * xp + (alpha / g.num_vertices) * dm[None, :] + (1.0 - alpha) * vbar
    return P


def topk_fixed(P: torch.Tensor, pers: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [K, k], raw [K, k]) of each column's k highest raw values, its
    own vertex left out, ties to the lower vertex id."""
    v, kk = P.shape
    p = torch.as_tensor(np.asarray(pers, np.int64), device=P.device)
    rev = (v - 1 - torch.arange(v, device=P.device, dtype=torch.int64))[:, None]
    key = P * v + rev                       # unique: raw first, then lower id
    key[p, torch.arange(kk, device=P.device)] = -1
    top = torch.topk(key, k, dim=0).values.T          # [K, k], descending
    return (v - 1 - top % v).cpu().numpy(), (top // v).cpu().numpy()


def column_scores(P: torch.Tensor, pers: np.ndarray) -> torch.Tensor:
    """[K, V] float64 scores with each column's own vertex at -inf."""
    s = P.to(torch.float64).T.clone()
    p = torch.as_tensor(np.asarray(pers, np.int64), device=P.device)
    s[torch.arange(s.shape[0], device=P.device), p] = -float("inf")
    return s


def topk_float(P: torch.Tensor, pers: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [K, k], scores [K, k]) of each column's k highest, its own vertex
    left out (ties in float64 are left to ``torch.topk``: the float check
    compares values, not the order of equal ones)."""
    top = torch.topk(column_scores(P, pers), k, dim=1)
    return top.indices.cpu().numpy(), top.values.cpu().numpy()
