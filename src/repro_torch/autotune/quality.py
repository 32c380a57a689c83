"""Online ranking-quality estimation via shadow sampling (paper Figs. 4-6).

Counterpart of ``repro.autotune.quality`` (numpy, copied: the same seeded
``Generator`` draws, so a replayed query sequence makes the reference's
sampling decisions draw for draw).

The paper establishes the quality/bit-width curve offline, on static graphs.
A serving system cannot: quality at a given Q format drifts with the graph
(sparsity, skew — Fig. 6) and with the query mix, so the controller needs an
*online* estimate of "how good is format F on graph G right now".

``QualityEstimator`` shadow-samples a configurable fraction of served queries:
for a sampled query the service re-runs the wave's personalization column at
the float32 reference precision and scores the served (fixed-point) ranking
against it with the paper's own metrics (``core.metrics`` NDCG / precision@k).
Scores land in per-(graph, format) sliding windows; the window mean is the
estimate the precision controller steers on.

Sampling uses a dedicated seeded ``numpy`` Generator so a replayed query
sequence makes identical sampling decisions — load tests and CI smoke runs are
reproducible bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.metrics import ndcg, precision_at, ranking

#: supported online metrics: name → callable(approx, ref, k, ref_order) → score
_METRICS = {
    "ndcg": lambda a, r, k, ro: ndcg(a, r, k, ref_order=ro),
    "precision": lambda a, r, k, ro: precision_at(a, r, k, ref_order=ro),
}


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Shadow-sampling policy.

    ``sample_fraction``  probability a served query is shadow-scored (each
                         shadow costs one float32 reference column).
    ``window``           sliding-window length per (graph, format).
    ``min_samples``      below this many window entries ``estimate`` abstains
                         (returns None) — the controller holds its rung.
    ``metric``/``eval_k`` which paper metric the estimate is, and its cutoff.
    ``seed``             RNG seed for the sampling decisions (determinism).
    """
    sample_fraction: float = 0.25
    window: int = 32
    min_samples: int = 3
    metric: str = "ndcg"
    eval_k: int = 50
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.sample_fraction <= 1.0:
            raise ValueError("sample_fraction must be in [0, 1]")
        if self.metric not in _METRICS:
            raise ValueError(f"unknown metric {self.metric!r} "
                             f"(have {sorted(_METRICS)})")
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")


def score_quality(approx: np.ndarray, ref: np.ndarray, *,
                  metric: str = "ndcg", k: int = 50,
                  ref_order: Optional[np.ndarray] = None) -> float:
    """Score one served score vector against its float32 reference."""
    approx = np.asarray(approx, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(_METRICS[metric](approx, ref, k, ref_order))


class QualityEstimator:
    """Per-(graph, format) sliding-window quality estimates from shadow samples."""

    def __init__(self, config: ShadowConfig = ShadowConfig()):
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._windows: Dict[Tuple[str, str], Deque[float]] = {}
        self.shadow_evaluations = 0            # reference runs actually scored

    # -- sampling ------------------------------------------------------
    def should_sample(self) -> bool:
        """One deterministic coin flip per served candidate query."""
        if self.config.sample_fraction >= 1.0:
            return True
        if self.config.sample_fraction <= 0.0:
            return False
        return float(self._rng.random()) < self.config.sample_fraction

    # -- observation ---------------------------------------------------
    def record(self, graph: str, fmt_key: str, score: float) -> None:
        """Append an externally-computed quality score to a window (used for
        the float32-served path, whose quality is 1.0 by definition)."""
        key = (graph, fmt_key)
        if key not in self._windows:
            self._windows[key] = deque(maxlen=self.config.window)
        self._windows[key].append(float(score))

    def observe(self, graph: str, fmt_key: str,
                approx: np.ndarray, ref: np.ndarray,
                ref_order: Optional[np.ndarray] = None) -> float:
        """Score one shadow sample and fold it into the (graph, format) window.
        Pass ``ref_order=ranking(ref)`` when one reference scores several
        formats — the reference is then sorted once."""
        score = score_quality(approx, ref, metric=self.config.metric,
                              k=self.config.eval_k, ref_order=ref_order)
        self.shadow_evaluations += 1
        self.record(graph, fmt_key, score)
        return score

    # -- estimates -----------------------------------------------------
    def estimate(self, graph: str, fmt_key: str) -> Optional[float]:
        """Window-mean quality, or None while the window is too thin to act on."""
        w = self._windows.get((graph, fmt_key))
        if w is None or len(w) < self.config.min_samples:
            return None
        return float(np.mean(w))

    def samples(self, graph: str, fmt_key: str) -> int:
        w = self._windows.get((graph, fmt_key))
        return len(w) if w is not None else 0

    def snapshot(self) -> Dict[str, float]:
        """All current estimates, keyed 'graph/format' (telemetry/bench dump)."""
        out = {}
        for (graph, fmt_key) in self._windows:
            est = self.estimate(graph, fmt_key)
            if est is not None:
                out[f"{graph}/{fmt_key}"] = est
        return out

    def forget_graph(self, graph: str) -> None:
        """Drop a graph's windows (it was re-registered — estimates are stale)."""
        for key in [k for k in self._windows if k[0] == graph]:
            del self._windows[key]

    def decay_graph(self, graph: str, keep_fraction: float = 0.5) -> None:
        """Shrink a graph's windows to their newest ``keep_fraction`` samples.

        An edge delta makes old shadow scores *weaker* evidence, not no
        evidence — the topology moved a little, not wholesale.  Decayed
        windows may drop below ``min_samples``, in which case ``estimate``
        abstains until fresh shadow traffic refills them; full
        re-registration still hard-resets via ``forget_graph``."""
        if not 0.0 <= keep_fraction <= 1.0:
            raise ValueError(f"keep_fraction must be in [0, 1], got {keep_fraction}")
        for (g, _), w in self._windows.items():
            if g != graph or not w:
                continue
            keep = int(np.ceil(len(w) * keep_fraction))
            kept = list(w)[len(w) - keep:]
            w.clear()
            w.extend(kept)


__all__ = ["ShadowConfig", "QualityEstimator", "score_quality", "ranking"]
