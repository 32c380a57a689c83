"""IR ranking metrics for PPR accuracy (paper §5.3.1, Figs. 4-6).

Counterpart of ``repro.core.metrics`` (numpy, copied: the same arithmetic,
so every metric equals the reference's exactly on the same arrays).

All metrics compare an approximate ranking (fixed-point FPGA analogue) against a
converged reference ranking (the CPU float64 oracle).

- num_errors@N  : vertices whose position in the top-N differs (coarse; the
                  paper's example {2,4,8,6} vs {4,8,6,2} → 4 errors).
- edit_distance@N : Levenshtein distance between top-N sequences.
- NDCG          : rel_i = |V| − i (paper's relevance), log2 discount, normalized
                  by the reference's ideal DCG.
- precision@N   : |topN_approx ∩ topN_ref| / N (order-insensitive).
- kendall_tau@N : pairwise order agreement on the reference top-N.
- MAE           : mean |score_approx − score_ref| over all vertices.

Every top-N metric accepts precomputed ``approx_order`` / ``ref_order`` full
rankings (from :func:`ranking`) so hot-path callers — ``full_report`` itself and
the serving-side shadow quality estimator (repro_torch.autotune.quality), which scores
a sampled fraction of *all served queries* — sort each score vector once instead
of once per metric.  N larger than |V| is clamped to |V| everywhere.

``kendall_tau`` uses scipy when available and falls back to a pure-numpy τ-b
(O(N²) pairwise, fine for top-N sizes) so a scipy-less environment never loses
``full_report``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:  # scipy is optional: the tier-1 env may not ship it
    from scipy.stats import kendalltau as _scipy_kendalltau
except Exception:  # pragma: no cover - exercised only in scipy-less envs
    _scipy_kendalltau = None


def ranking(scores: np.ndarray) -> np.ndarray:
    """Full deterministic ranking: indices by descending score, ties broken by
    ascending vertex id.  ``topk_indices(s, k) == ranking(s)[:k]``."""
    scores = np.asarray(scores)
    # argsort on (-score, idx): stable deterministic ranking
    return np.lexsort((np.arange(scores.shape[0]), -scores))


def topk_indices(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, ties broken by vertex id (deterministic).
    k beyond |V| returns all |V| indices."""
    return ranking(scores)[:k]


def _order(scores: np.ndarray, precomputed: Optional[np.ndarray]) -> np.ndarray:
    return ranking(scores) if precomputed is None else np.asarray(precomputed)


def num_errors(approx: np.ndarray, ref: np.ndarray, n: int, *,
               approx_order: Optional[np.ndarray] = None,
               ref_order: Optional[np.ndarray] = None) -> int:
    ta = _order(approx, approx_order)[:n]
    tr = _order(ref, ref_order)[:n]
    return int((ta != tr).sum())


def edit_distance(approx: np.ndarray, ref: np.ndarray, n: int, *,
                  approx_order: Optional[np.ndarray] = None,
                  ref_order: Optional[np.ndarray] = None) -> int:
    """Levenshtein distance between the two top-N vertex sequences."""
    a = _order(approx, approx_order)[:n].tolist()
    b = _order(ref, ref_order)[:n].tolist()
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[lb])


def ndcg(approx: np.ndarray, ref: np.ndarray, n: int | None = None, *,
         approx_order: Optional[np.ndarray] = None,
         ref_order: Optional[np.ndarray] = None) -> float:
    """Paper's NDCG: rel of vertex = |V| − (its reference rank); DCG over the
    approx ordering; normalized by the reference (ideal) DCG."""
    v = ref.shape[0]
    n = min(n or v, v)
    ref_order = _order(ref, ref_order)
    rel = np.empty(v, np.float64)
    rel[ref_order] = v - np.arange(v)          # rel_i = |V| - rank_i
    approx_top = _order(approx, approx_order)[:n]
    discounts = 1.0 / np.log2(np.arange(1, n + 1) + 1)
    dcg = float((rel[approx_top] * discounts).sum())
    idcg = float((rel[ref_order[:n]] * discounts).sum())
    return dcg / idcg if idcg > 0 else 1.0


def precision_at(approx: np.ndarray, ref: np.ndarray, n: int, *,
                 approx_order: Optional[np.ndarray] = None,
                 ref_order: Optional[np.ndarray] = None) -> float:
    n = min(n, np.asarray(ref).shape[0])
    ta = set(_order(approx, approx_order)[:n].tolist())
    tr = set(_order(ref, ref_order)[:n].tolist())
    return len(ta & tr) / float(n) if n else 1.0


def _kendall_tau_b(x: np.ndarray, y: np.ndarray) -> float:
    """Pure-numpy Kendall τ-b: (C − D) / √((n₀ − ties_x)(n₀ − ties_y)) over all
    pairs.  O(N²) memory/time — intended for top-N slices, not full graphs."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    if n < 2:
        return float("nan")
    iu = np.triu_indices(n, 1)
    dx = np.sign(x[:, None] - x[None, :])[iu]
    dy = np.sign(y[:, None] - y[None, :])[iu]
    num = float((dx * dy).sum())               # C − D (tied pairs contribute 0)
    n0 = dx.shape[0]
    denom = np.sqrt(float(n0 - (dx == 0).sum()) * float(n0 - (dy == 0).sum()))
    return num / denom if denom > 0 else float("nan")


def kendall_tau(approx: np.ndarray, ref: np.ndarray, n: int, *,
                ref_order: Optional[np.ndarray] = None) -> float:
    """Kendall's τ-b restricted to the reference top-N vertices."""
    idx = _order(ref, ref_order)[:n]
    if _scipy_kendalltau is not None:
        tau, _ = _scipy_kendalltau(ref[idx], approx[idx])
    else:
        tau = _kendall_tau_b(ref[idx], approx[idx])
    return float(tau) if np.isfinite(tau) else 1.0


def mae(approx: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(np.asarray(approx, np.float64) - np.asarray(ref, np.float64)).mean())


def full_report(approx: np.ndarray, ref: np.ndarray,
                ns: Sequence[int] = (10, 20, 50), *,
                ref_order: Optional[np.ndarray] = None) -> dict:
    """All paper metrics for one (approx, ref) score-vector pair.

    Both score vectors are ranked exactly once; pass ``ref_order=ranking(ref)``
    when scoring many approximations against one fixed reference (the shadow
    estimator's hot path) to skip even that sort.
    """
    approx_order = ranking(approx)
    ref_order = _order(ref, ref_order)
    kw = {"approx_order": approx_order, "ref_order": ref_order}
    rep = {"mae": mae(approx, ref), "ndcg": ndcg(approx, ref, max(ns), **kw)}
    for n in ns:
        rep[f"errors@{n}"] = num_errors(approx, ref, n, **kw)
        rep[f"edit@{n}"] = edit_distance(approx, ref, n, **kw)
        rep[f"precision@{n}"] = precision_at(approx, ref, n, **kw)
        rep[f"kendall@{n}"] = kendall_tau(approx, ref, n, ref_order=ref_order)
    return rep


def aggregate_reports(reports: Sequence[dict]) -> dict:
    """Mean of each metric over a batch of personalization vertices."""
    keys = reports[0].keys()
    return {k: float(np.mean([r[k] for r in reports])) for k in keys}
