"""CPU reference PPR — the paper's PGX baseline stand-in.

Counterpart of ``repro.graphs.reference`` (scipy, copied).

scipy CSR float64 power iteration; this is the "ground truth at convergence"
(≥100 iterations) against which fixed-point rankings are scored (paper §5.3).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from repro_torch.core.coo import COOGraph


def ppr_reference(
    g: COOGraph,
    personalization: np.ndarray,
    alpha: float = 0.85,
    iterations: int = 100,
    tol: float = 0.0,
) -> np.ndarray:
    """Batched PPR via scipy CSR, float64.  Returns [V, K] scores.

    Implements eq. (1): P_{t+1} = α·X·P_t + α/|V|·(d̄·P_t)·1 + (1−α)·V̄.
    """
    v = g.num_vertices
    pers = np.atleast_1d(np.asarray(personalization, np.int64))
    k = pers.shape[0]
    X = sp.csr_matrix(
        (g.val.astype(np.float64), (g.x.astype(np.int64), g.y.astype(np.int64))),
        shape=(v, v),
    )
    V = np.zeros((v, k), np.float64)
    V[pers, np.arange(k)] = 1.0
    d = g.dangling.astype(np.float64)
    P = V.copy()
    for _ in range(iterations):
        dangling_mass = d @ P                             # [K]
        Pn = alpha * (X @ P) + (alpha / v) * dangling_mass[None, :] + (1 - alpha) * V
        delta = np.linalg.norm(Pn - P, axis=0).max()
        P = Pn
        if tol and delta < tol:
            break
    return P
