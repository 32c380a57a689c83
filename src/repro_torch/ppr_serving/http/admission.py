"""Admission control for the HTTP serving tier — the load knobs, in order.

Counterpart of ``repro.ppr_serving.http.admission``, copied as it is (stdlib only).

The service values low latency over exact convergence (the paper's whole
premise), so overload is met with *graceful degradation*, escalating as the
admission queue deepens:

1. **Deepen κ** (``deepen_water``): batch more personalization columns per
   wave before anything is refused — one edge-stream pass amortized over 2κ
   queries is the paper's own economics, bought at a modest per-wave latency
   cost.  Doublings only (each distinct κ compiles its own wave shapes),
   capped at ``kappa_max``; relaxes on the same thresholds going down.
2. **Degrade quality** (``degrade_water``): impose a quality-target ceiling
   on ``precision="auto"`` resolution (serve ``degraded_target`` — e.g. 0.93
   — instead of the requested 0.95), the serving-side turn of the paper's
   precision/quality dial.  Lifts at ``degrade_low_water`` (hysteresis).
3. **Shed** (``high_water``): reject new arrivals with HTTP 429 +
   ``Retry-After`` so admitted traffic keeps a bounded p95 instead of
   everyone timing out together.  Stops shedding only once the queue drains
   below ``low_water`` — the gap is what keeps shedding from flapping at the
   boundary.

Every decision is counted in ``ServiceTelemetry`` (the ``queries_shed`` /
``slo_*`` / ``kappa_*`` counters and the queue gauges), so ``/v1/stats`` is
the full audit trail of what quality was traded when, and whether it
recovered.

When the service carries an ``SLOMonitor`` (``PPRService(slo=...)``), the
controller closes the loop the monitor opens: each tick also advances the
monitor, and a *burning* latency or shed SLO pushes the same ladder —
κ deepens to at least its first rung and the quality ceiling engages even
while the queue alone looks healthy (burn is the leading indicator; depth
the trailing one).  A burning *quality* SLO does the opposite: it vetoes
the degrade step (and lifts an active ceiling), because trading more
quality while the quality objective is already out of budget digs the
hole deeper.  Every SLO-driven move is counted
(``ppr_slo_advisory_total{action=deepen|degrade|veto}``) and lands in the
flight recorder, so depth-driven and burn-driven decisions stay
distinguishable after the fact.

The controller is transport-independent: it only needs a ``PPRService`` (its
``queue_depth``/``set_kappa``/``degrade_quality``/``restore_quality`` hooks)
and a clock — unit tests drive it with a fake depth signal and no sockets.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

__all__ = ["AdmissionConfig", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Water marks are admission-queue depths (pending queries).  Defaults
    suit a κ=8 service; scale them with κ — the useful mental unit is
    "waves' worth of queries queued"."""
    high_water: int = 64           # shed new arrivals above this depth
    low_water: int = 16            # stop shedding once drained to this
    deepen_water: int = 16         # start deepening κ at this depth
    kappa_max: int = 64            # ceiling for deepened κ
    degrade_water: int = 32        # impose the quality ceiling above this
    degrade_low_water: int = 8     # lift it once drained to this
    degraded_target: float = 0.93  # the stepped-down quality target served
    retry_after_s: float = 0.1     # hint on 429 responses

    def __post_init__(self):
        if not 0 < self.low_water <= self.high_water:
            raise ValueError(
                f"need 0 < low_water <= high_water, got "
                f"{self.low_water}/{self.high_water}")
        if not 0 < self.degrade_low_water <= self.degrade_water:
            raise ValueError(
                f"need 0 < degrade_low_water <= degrade_water, got "
                f"{self.degrade_low_water}/{self.degrade_water}")
        if self.deepen_water < 1:
            raise ValueError(f"deepen_water must be >= 1, "
                             f"got {self.deepen_water}")
        if self.kappa_max < 1:
            raise ValueError(f"kappa_max must be >= 1, got {self.kappa_max}")
        if not 0.0 < self.degraded_target <= 1.0:
            raise ValueError(f"degraded_target must be in (0, 1], "
                             f"got {self.degraded_target}")
        if self.retry_after_s <= 0:
            raise ValueError(f"retry_after_s must be > 0, "
                             f"got {self.retry_after_s}")


class AdmissionController:
    """Hysteretic shed/degrade/deepen state machine over the service's
    queue-depth signal."""

    def __init__(self, service, config: AdmissionConfig = AdmissionConfig(),
                 slo=None):
        self.service = service
        self.config = config
        self.base_kappa = service.kappa
        if config.kappa_max < self.base_kappa:
            raise ValueError(
                f"kappa_max={config.kappa_max} is below the service's base "
                f"kappa={self.base_kappa} — the controller only deepens")
        # the burn-rate monitor feeding the advisory signal: explicit, or
        # the service's own (PPRService(slo=...)); None keeps the controller
        # purely depth-driven, bit-identical to the pre-SLO behavior
        self.slo = slo if slo is not None else getattr(service, "slo", None)
        self.shedding = False
        self.degrading = False
        self.admitted = 0
        self.shed = 0

    # ------------------------------------------------------------------
    def target_kappa(self, depth: int) -> int:
        """Pure policy: κ for a given queue depth — one doubling per
        doubling of depth past ``deepen_water``, so the set of compiled wave
        shapes stays logarithmic in the overload."""
        kappa, thresh = self.base_kappa, self.config.deepen_water
        while depth >= thresh and kappa * 2 <= self.config.kappa_max:
            kappa *= 2
            thresh *= 2
        return kappa

    def tick(self, now: Optional[float] = None) -> int:
        """One control cycle: read the depth, update the three knobs, record
        the gauges.  Called by the pump every cycle and by ``admit`` on every
        arrival (depth moves fastest exactly when decisions matter most).
        Returns the depth it acted on."""
        svc, cfg = self.service, self.config
        depth = svc.queue_depth()
        svc.telemetry.record_queue_depth(depth, svc.oldest_wait_s(now))

        # SLO advisory: a burning latency/shed SLO pushes the ladder ahead
        # of queue depth; a burning quality SLO vetoes further degradation.
        push = veto = False
        if self.slo is not None:
            self.slo.tick(now)
            kinds = self.slo.burning_kinds()
            push = bool(kinds & {"latency", "shed"})
            veto = "quality" in kinds

        # burn counts as if the queue had already reached the deepen mark —
        # the first κ doubling lands before depth alone would take it
        kappa = self.target_kappa(
            max(depth, cfg.deepen_water) if push else depth)
        if kappa != svc.kappa:
            if push and kappa > svc.kappa and depth < cfg.deepen_water:
                self._advise("deepen", now, depth=depth)
            svc.set_kappa(kappa)       # counts deepen/relax in telemetry

        want_degrade = depth > cfg.degrade_water or push
        if veto:
            # quality budget already burning: do not trade more quality, and
            # lift an active ceiling rather than hold it
            if self.degrading:
                self._advise("veto", now, depth=depth)
                self.degrading = False
                svc.restore_quality()
            elif want_degrade:
                self._advise("veto", now, depth=depth)
        elif not self.degrading and want_degrade:
            if push and depth <= cfg.degrade_water:
                self._advise("degrade", now, depth=depth)
            self.degrading = True
            svc.degrade_quality(cfg.degraded_target)
        elif self.degrading and depth <= cfg.degrade_low_water and not push:
            self.degrading = False
            svc.restore_quality()

        if not self.shedding and depth > cfg.high_water:
            self.shedding = True
            svc.telemetry.record_shed_transition(engaged=True)
            self._event("shed_engaged", now, depth=depth)
        elif self.shedding and depth <= cfg.low_water:
            self.shedding = False
            svc.telemetry.record_shed_transition(engaged=False)
            self._event("shed_recovered", now, depth=depth)
        return depth

    def _advise(self, action: str, now: Optional[float], **attrs) -> None:
        """Count + record one SLO-driven ladder move (``deepen`` /
        ``degrade`` / ``veto``) — what separates burn-driven decisions from
        plain depth-driven ones in the audit trail."""
        telemetry = getattr(self.service, "telemetry", None)
        if telemetry is not None and hasattr(telemetry, "record_slo_advisory"):
            telemetry.record_slo_advisory(action)
        self._event("slo_advisory", now, action=action, **attrs)

    def _event(self, kind: str, now: Optional[float], **attrs) -> None:
        """Shed transitions into the service's flight recorder, when it has
        one — unit tests drive this controller with bare stub services."""
        recorder = getattr(self.service, "recorder", None)
        if recorder is None:
            return
        if now is None:
            now = getattr(self.service, "time_fn", time.monotonic)()
        recorder.record_event(kind, now, **attrs)

    def admit(self, now: Optional[float] = None,
              graph: Optional[str] = None) -> Optional[float]:
        """Per-arrival decision: ``None`` admits; a float sheds, carrying the
        ``Retry-After`` hint in seconds.  ``graph`` attributes a shed to the
        graph whose traffic was rejected (the per-graph counter label)."""
        self.tick(now)
        if self.shedding:
            self.shed += 1
            if graph is None:
                self.service.telemetry.record_shed()
            else:
                self.service.telemetry.record_shed(graph=graph)
            return self.config.retry_after_s
        self.admitted += 1
        return None

    def stats(self) -> Dict[str, float]:
        out = {
            "admitted": self.admitted,
            "shed": self.shed,
            "shedding": self.shedding,
            "degrading": self.degrading,
            "kappa": self.service.kappa,
            "base_kappa": self.base_kappa,
        }
        if self.slo is not None:
            out["slo_burning"] = sorted(self.slo.burning())
        return out
