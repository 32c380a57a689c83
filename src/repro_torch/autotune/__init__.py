"""Adaptive-precision subsystem (counterpart of ``repro.autotune``).

``quality.py``      shadow-samples a fraction of served ``precision="auto"``
                    queries, re-runs their personalization columns at
                    float32 and keeps per-(graph, format) sliding-window NDCG
                    (or precision@k) estimates; seeded sampling keeps replays
                    deterministic.
``controller.py``   walks the paper's quality/bit-width curve (Figs. 4-6) as
                    a per-graph ladder of Q formats with a float32 fallback
                    rung, with hysteresis in both directions and a backoff on
                    reverted promotions.
``convergence.py``  early exit at the fixed-point absorbing state or below
                    the float threshold (Fig. 7).

``repro_torch.ppr_serving.PPRService`` resolves ``precision="auto"`` through
the controller before wave admission and feeds shadow scores back after each
wave.
"""
from repro_torch.autotune.controller import (
    DEFAULT_LADDER,
    AutotuneConfig,
    PrecisionController,
)
from repro_torch.autotune.convergence import (
    ConvergenceMonitor,
    ConvergencePolicy,
    run_until_converged,
    states_equal,
    wave_delta,
)
from repro_torch.autotune.quality import QualityEstimator, ShadowConfig, score_quality

__all__ = [
    "AutotuneConfig", "PrecisionController", "DEFAULT_LADDER",
    "QualityEstimator", "ShadowConfig", "score_quality",
    "ConvergencePolicy", "ConvergenceMonitor", "run_until_converged",
    "wave_delta", "states_equal",
]
