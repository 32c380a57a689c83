"""Quality-targeted precision ladder with hysteresis (paper Figs. 4-6 closed-loop).

Counterpart of ``repro.autotune.controller`` (host Python, copied).

The paper's offline finding — ranking quality degrades gracefully and
predictably as bits shrink from Q1.25 to Q1.19 — becomes a serving policy: a
per-graph ladder of Q formats ordered by cost, walked up and down by the shadow
estimator's window estimates so each ``precision="auto"`` query is served at
the *cheapest* format currently meeting its quality target.

Rungs are the configured fixed-point bit-widths (narrowest = cheapest first)
plus a float32 fallback rung above the widest — a graph whose quality target is
unreachable at any configured format degrades to exact float32 service instead
of failing.

Hysteresis: one bad shadow window must not thrash the ladder (a format change
invalidates wave batching locality and the per-format quantized-value cache is
re-warmed).  Demotion (→ wider) requires ``demote_patience`` *consecutive*
below-target estimates; promotion (→ narrower) requires ``promote_patience``
consecutive estimates clearing the target by ``promote_margin``.  Estimates in
the dead band between the two reset both streaks.  An alternating good/bad
sequence therefore never moves the rung in either direction.  A *reverted*
promotion (probe a narrower rung, get demoted straight back) doubles the
promote requirement for that (graph, target) — exponential backoff, reset
when a probe survives long enough to promote again or when the graph is
re-registered — so a format that persistently misses its target is re-probed
geometrically less often instead of thrash-cycling forever.

Float32-served auto queries are perfect by definition (score 1.0, no shadow
reference needed); feeding those 1.0s through ``observe_quality`` is what lets
a demoted graph climb back down to fixed point once ``promote_patience`` is
re-accumulated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.fixed_point import QFormat, format_for_bits
from repro_torch.autotune.quality import QualityEstimator, ShadowConfig

#: paper §5.3 bit-widths, cheapest first (20 bits = Q1.19 … 26 bits = Q1.25)
DEFAULT_LADDER: Tuple[int, ...] = (20, 22, 24, 26)

#: rung key for the float32 fallback (matches ppr_serving's FLOAT_KEY)
FLOAT_RUNG = "f32"


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Ladder + hysteresis + shadow-sampling policy for one service."""
    ladder: Tuple[int, ...] = DEFAULT_LADDER
    default_target: float = 0.95
    promote_patience: int = 3          # consecutive good windows before narrowing
    demote_patience: int = 2           # consecutive bad windows before widening
    promote_margin: float = 0.005      # narrow only when target is cleared by this
    shadow: ShadowConfig = ShadowConfig()

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("ladder must name at least one bit-width")
        if list(self.ladder) != sorted(set(self.ladder)):
            raise ValueError("ladder must be strictly increasing bit-widths")
        if self.promote_patience < 1 or self.demote_patience < 1:
            raise ValueError("patience values must be >= 1")


@dataclasses.dataclass
class _RungState:
    """Ladder position + hysteresis streaks for one (graph, target)."""
    rung: int                          # index into ladder; len(ladder) ⇒ float32
    good: int = 0
    bad: int = 0
    promote_backoff: int = 1           # multiplies promote_patience; doubles
    probing: bool = False              # each time a promotion is reverted


class PrecisionController:
    """Resolve ``precision="auto"`` to the cheapest format meeting the target."""

    def __init__(self, config: AutotuneConfig = AutotuneConfig(),
                 estimator: Optional[QualityEstimator] = None):
        self.config = config
        self.estimator = estimator or QualityEstimator(config.shadow)
        self._formats: Tuple[QFormat, ...] = tuple(
            format_for_bits(b) for b in config.ladder)
        self._states: Dict[Tuple[str, float], _RungState] = {}
        self._target_ceiling: Optional[float] = None
        self.promotions = 0
        self.demotions = 0

    # -- rung bookkeeping ----------------------------------------------
    def _target(self, target: Optional[float]) -> float:
        t = self.config.default_target if target is None else float(target)
        if not 0.0 < t <= 1.0:
            raise ValueError(f"quality target must be in (0, 1], got {t}")
        if self._target_ceiling is not None:
            t = min(t, self._target_ceiling)
        return round(t, 6)

    @property
    def target_ceiling(self) -> Optional[float]:
        """The SLO-degradation ceiling currently capping every effective
        quality target, or None when serving at requested quality."""
        return self._target_ceiling

    def set_target_ceiling(self, ceiling: Optional[float]) -> None:
        """Temporarily cap effective quality targets (SLO-aware degradation:
        a deep admission queue trades NDCG target for wave latency).

        While set, every ``resolve``/``observe_*`` maps its requested target
        through ``min(target, ceiling)`` — so degraded traffic walks its own
        (graph, degraded-target) ladder, whose rung may be a cheaper format,
        and shadow feedback gathered under the ceiling steers that ladder
        rather than polluting the full-quality one.  ``None`` lifts the cap;
        the full-quality ladders resume exactly where they left off."""
        if ceiling is not None and not 0.0 < float(ceiling) <= 1.0:
            raise ValueError(f"target ceiling must be in (0, 1] or None, "
                             f"got {ceiling}")
        self._target_ceiling = None if ceiling is None else float(ceiling)

    def _state(self, graph: str, target: Optional[float]) -> _RungState:
        key = (graph, self._target(target))
        if key not in self._states:
            # start at the widest fixed format: cheaper than float32 on day one,
            # and the paper's safest quality point to gather first samples at
            self._states[key] = _RungState(rung=len(self._formats) - 1)
        return self._states[key]

    def _rung_format(self, rung: int) -> Optional[QFormat]:
        return None if rung >= len(self._formats) else self._formats[rung]

    def rung_key(self, graph: str, target: Optional[float] = None) -> str:
        """Telemetry-friendly name of the current rung ('Q1.f' or 'f32')."""
        fmt = self._rung_format(self._state(graph, target).rung)
        return FLOAT_RUNG if fmt is None else fmt.name

    # -- the two public verbs ------------------------------------------
    def resolve(self, graph: str, target: Optional[float] = None
                ) -> Optional[QFormat]:
        """Precision for the next auto query on (graph, target): a ``QFormat``
        or None for the float32 fallback rung."""
        return self._rung_format(self._state(graph, target).rung)

    def observe_quality(self, graph: str, fmt_key: str, score: float,
                        target: Optional[float] = None) -> None:
        """Fold an externally-scored observation into the estimator and advance
        the ladder (used directly for float32-served queries, score 1.0)."""
        self.estimator.record(graph, fmt_key, score)
        self._steer(graph, fmt_key, target)

    def observe_shadow(self, graph: str, fmt_key: str,
                       approx: np.ndarray, ref: np.ndarray,
                       target: Optional[float] = None,
                       ref_order: Optional[np.ndarray] = None) -> float:
        """Score one shadow sample, then steer.  Returns the sample's score."""
        score = self.estimator.observe(graph, fmt_key, approx, ref, ref_order)
        self._steer(graph, fmt_key, target)
        return score

    # -- hysteresis ----------------------------------------------------
    def _steer(self, graph: str, fmt_key: str, target: Optional[float]) -> None:
        st = self._state(graph, target)
        current_fmt = self._rung_format(st.rung)
        current_key = FLOAT_RUNG if current_fmt is None else current_fmt.name
        if fmt_key != current_key:
            return                      # stale sample from a pre-move format
        est = self.estimator.estimate(graph, fmt_key)
        if est is None:
            return                      # window too thin — hold the rung
        t = self._target(target)
        if est < t:
            st.bad += 1
            st.good = 0
            if st.bad >= self.config.demote_patience \
                    and st.rung < len(self._formats):
                st.rung += 1            # widen (toward float32)
                if st.probing:          # the probed narrower rung failed:
                    st.promote_backoff = min(st.promote_backoff * 2, 64)
                st.probing = False      # re-probe it geometrically less often
                st.bad = st.good = 0
                self.demotions += 1
        elif est >= t + self.config.promote_margin:
            st.good += 1
            st.bad = 0
            if st.good >= self.config.promote_patience * st.promote_backoff \
                    and st.rung > 0:
                if st.probing:          # last probe stuck around long enough
                    st.promote_backoff = 1       # to promote again: trust it
                st.rung -= 1            # narrow (cheaper format)
                st.probing = True
                st.bad = st.good = 0
                self.promotions += 1
        else:
            # dead band: on target but without margin — hold, reset streaks
            st.good = st.bad = 0

    # -- lifecycle -----------------------------------------------------
    def decay_graph(self, graph: str, keep_fraction: float = 0.5) -> None:
        """Epoch change (edge delta applied): soften the evidence instead of
        forgetting it.  Rung positions and promote backoff survive — the
        quality/bit-width curve moves smoothly with small topology changes
        (paper Fig. 6's sparsity dependence) — while hysteresis streaks reset
        (they described the pre-delta topology) and the estimator windows
        decay toward fresh post-delta shadow samples."""
        for key, st in self._states.items():
            if key[0] == graph:
                st.good = st.bad = 0
        self.estimator.decay_graph(graph, keep_fraction)

    def forget_graph(self, graph: str) -> None:
        """Reset ladder state and estimator windows for a re-registered graph."""
        for key in [k for k in self._states if k[0] == graph]:
            del self._states[key]
        self.estimator.forget_graph(graph)

    def summary(self) -> Dict[str, float]:
        """Counters plus the current rung bit-width per (graph, target)
        (float32 fallback reported as 32)."""
        out = {"promotions": float(self.promotions),
               "demotions": float(self.demotions),
               "shadow_evaluations": float(self.estimator.shadow_evaluations)}
        for (graph, target), st in self._states.items():
            bits = 32 if st.rung >= len(self._formats) else self.config.ladder[st.rung]
            out[f"rung_bits_{graph}@{target}"] = float(bits)
        return out
