"""SLO monitoring — declarative objectives + multi-window burn-rate alerting.

Counterpart of ``repro.obs.slo``, copied as it is (stdlib only).

The paper's premise is trading exact convergence for latency/throughput under
a quality floor; in a serving system those are literally SLOs on three axes
the stack already measures:

``latency``   admitted-query latency ≤ ``objective`` seconds for at least
              ``1 - budget`` of queries (budget=0.05 ⇒ "p95 ≤ objective"),
              read from the ``ppr_query_latency_seconds`` histogram.
``shed``      shed arrivals ≤ ``budget`` of all arrivals, read from the
              served / shed / deadline-shed counters.
``quality``   shadow-scored NDCG ≥ ``objective`` for at least ``1 - budget``
              of sampled auto queries, read from ``ppr_shadow_quality``.

All three reduce to the same error-budget algebra: a *bad fraction* measured
over a sliding window, divided by the allowed ``budget``, is the **burn
rate** — 1.0 burns the budget exactly at the sustainable pace, 14 exhausts a
5%% budget in hours.  ``SLOMonitor`` evaluates each spec with the
SRE-workbook multi-window scheme: alert when *both* windows of the fast pair
(default 5m/1h) exceed ``fast_burn``, or both of the slow pair (1h/6h) exceed
``slow_burn``; recover with hysteresis once the short windows drop below
``recover_burn`` — the wide gap between engage (≥14) and recover (<1)
thresholds is what keeps the alert from flapping at the boundary.

The monitor never observes events itself: it periodically *samples*
cumulative (good, bad) totals from the ``MetricsRegistry`` families the
service already maintains, holds a bounded ring of those snapshots, and
differences them against window baselines.  Histogram-backed SLOs
(latency/quality) resolve objectives at bucket granularity — an objective
between bounds is effectively rounded down to the nearest bucket bound, so
pick objectives on the bucket grid (latency buckets are doublings of 1 µs;
quality buckets are the 0.05 grid).  With no samples older than a window yet
(startup, tests), the window is evaluated from the oldest sample available —
a flood right after boot alerts without waiting an hour for history.

Alert transitions land three ways: a ``slo_burning``/``slo_recovered``
control-plane event in the flight recorder, the ``slo_state`` gauge +
``slo_transitions_total`` counter in the registry (so ``GET /v1/metrics``
carries them), and ``status()`` — what ``GET /v1/slo`` serves.
``burning_kinds()`` is the advisory read the admission controller closes the
loop with: latency/shed burn pushes the deepen-κ → degrade ladder, quality
burn vetoes degradation (degrading further would burn it harder).

Clock-injected and stdlib-only, like everything in ``repro_torch.obs``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, FrozenSet, List, Optional, Sequence, Tuple

__all__ = ["SLO_KINDS", "SLOSpec", "SLOMonitor", "default_slo_specs"]

SLO_KINDS = ("latency", "shed", "quality")

#: registry families the monitor samples (created get-or-create, so a bare
#: registry under test works; in the service they already exist with help)
LATENCY_FAMILY = "ppr_query_latency_seconds"
SERVED_FAMILY = "ppr_queries_served_total"
SHED_FAMILY = "ppr_queries_shed_total"
DEADLINE_SHED_FAMILY = "ppr_queries_deadline_shed_total"
QUALITY_FAMILY = "ppr_shadow_quality"

#: unit-interval bounds of the shadow-quality histogram (must match
#: ServiceTelemetry's — duplicated here because obs must not import serving)
_UNIT_BUCKETS = tuple(i / 20 for i in range(1, 21))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One objective: what fraction of events may be bad, over which windows.

    ``objective`` is the latency bound in seconds (kind="latency") or the
    quality floor in NDCG (kind="quality"); unused for kind="shed", where
    every shed arrival is bad by definition.  ``budget`` is the allowed bad
    fraction (0.05 ⇒ 95%% compliance).  ``graph=None`` aggregates across
    every graph; naming one scopes the SLO to that graph's series."""
    name: str
    kind: str
    objective: float = 0.0
    budget: float = 0.05
    graph: Optional[str] = None
    fast_windows: Tuple[float, float] = (300.0, 3600.0)
    slow_windows: Tuple[float, float] = (3600.0, 21600.0)
    fast_burn: float = 14.0
    slow_burn: float = 6.0
    recover_burn: float = 1.0
    #: windows with fewer events than this report burn 0 (no evidence)
    min_events: int = 1

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLOSpec needs a non-empty name")
        if self.kind not in SLO_KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(have {SLO_KINDS})")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.kind == "latency" and self.objective <= 0.0:
            raise ValueError(f"latency objective must be > 0 seconds, "
                             f"got {self.objective}")
        if self.kind == "quality" and not 0.0 < self.objective <= 1.0:
            raise ValueError(f"quality floor must be in (0, 1], "
                             f"got {self.objective}")
        for pair, label in ((self.fast_windows, "fast_windows"),
                            (self.slow_windows, "slow_windows")):
            if len(pair) != 2 or not 0 < pair[0] < pair[1]:
                raise ValueError(f"{label} must be (short, long) with "
                                 f"0 < short < long, got {pair}")
        if not self.fast_burn >= self.slow_burn > self.recover_burn > 0:
            raise ValueError(
                f"need fast_burn >= slow_burn > recover_burn > 0, got "
                f"{self.fast_burn}/{self.slow_burn}/{self.recover_burn}")
        if self.min_events < 1:
            raise ValueError(f"min_events must be >= 1, got {self.min_events}")

    @property
    def windows(self) -> Tuple[float, ...]:
        """Every distinct window length, ascending (the pairs may share)."""
        return tuple(sorted(set(self.fast_windows) | set(self.slow_windows)))


def default_slo_specs(latency_objective_s: float = 0.262144,
                      latency_budget: float = 0.05,
                      shed_budget: float = 0.05,
                      quality_floor: float = 0.90,
                      quality_budget: float = 0.10,
                      graph: Optional[str] = None) -> Tuple[SLOSpec, ...]:
    """The house spec set: p95 latency, shed rate, shadow-quality floor.

    The default latency objective sits exactly on a histogram bucket bound
    (1e-6 * 2^18 s ≈ 262 ms) so the bad-fraction read is exact."""
    return (
        SLOSpec("latency_p95", "latency", objective=latency_objective_s,
                budget=latency_budget, graph=graph),
        SLOSpec("shed_rate", "shed", budget=shed_budget, graph=graph),
        SLOSpec("shadow_quality", "quality", objective=quality_floor,
                budget=quality_budget),
    )


@dataclasses.dataclass
class _SpecState:
    """Mutable per-spec evaluation state inside the monitor."""
    spec: SLOSpec
    state: str = "ok"                       # "ok" | "burning"
    # (t, good_cum, bad_cum) snapshots, oldest first, pruned past the
    # longest window — O(window / resolution) memory, not O(queries)
    samples: Deque[Tuple[float, float, float]] = \
        dataclasses.field(default_factory=deque)
    good_total: float = 0.0
    bad_total: float = 0.0
    # last tick's per-window evaluation, what status() serves
    windows: Dict[float, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    transitions: int = 0


class SLOMonitor:
    """Evaluates a spec set against a registry on an injected clock.

    ``tick(now)`` is the only mutation: sample totals, difference against
    window baselines, run the alert state machine.  The serving tier ticks it
    from the admission controller (every arrival *and* every pump heartbeat),
    so burn is evaluated exactly when load moves; anything else may call
    ``tick`` too — it is idempotent within a ``resolution_s`` bucket."""

    def __init__(self, registry, specs: Sequence[SLOSpec],
                 time_fn=time.monotonic, recorder=None,
                 resolution_s: float = 1.0):
        if not specs:
            raise ValueError("SLOMonitor needs at least one SLOSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        if resolution_s < 0.0:
            raise ValueError(f"resolution_s must be >= 0, got {resolution_s}")
        self.registry = registry
        self.specs = tuple(specs)
        self.time_fn = time_fn
        self.recorder = recorder
        self.resolution_s = resolution_s
        self._states = {s.name: _SpecState(s) for s in self.specs}
        # slo_* families live beside the ppr_* ones so one scrape carries both
        self._burn = registry.gauge(
            "slo_burn_rate", "Error-budget burn rate per SLO and window "
            "(1.0 = budget consumed exactly at the sustainable pace).",
            labels=("slo", "window"))
        self._state_g = registry.gauge(
            "slo_state", "SLO alert state (0 = ok, 1 = burning).",
            labels=("slo",))
        self._transitions = registry.counter(
            "slo_transitions_total", "Alert state-machine transitions.",
            labels=("slo", "state"))
        self._ticks = registry.counter(
            "slo_ticks_total", "Monitor evaluation cycles.")
        for s in self.specs:
            self._state_g.labels(slo=s.name).set(0.0)

    # ------------------------------------------------------------------
    # cumulative (good, bad) totals per kind, read from the registry
    # ------------------------------------------------------------------
    def _series(self, family, graph: Optional[str]):
        for labels, inst in family.series():
            if graph is not None and any(
                    k == "graph" and v != graph for k, v in labels):
                continue
            yield inst

    @staticmethod
    def _hist_below(hist, threshold: float, inclusive: bool) -> int:
        """Observations ≤ the largest bound ≤ threshold (inclusive) or
        < threshold (exclusive) — bucket-granular, never over-counting."""
        cut = bisect.bisect_right(hist.bounds, threshold) if inclusive \
            else bisect.bisect_left(hist.bounds, threshold)
        return sum(hist.bucket_counts[:cut])

    def _totals(self, spec: SLOSpec) -> Tuple[float, float]:
        if spec.kind == "latency":
            fam = self.registry.histogram(LATENCY_FAMILY, labels=("graph",))
            good = bad = 0.0
            for hist in self._series(fam, spec.graph):
                g = self._hist_below(hist, spec.objective, inclusive=True)
                good += g
                bad += hist.count - g
            return good, bad
        if spec.kind == "shed":
            served = self.registry.counter(SERVED_FAMILY, labels=("graph",))
            shed = self.registry.counter(SHED_FAMILY, labels=("graph",))
            late = self.registry.counter(DEADLINE_SHED_FAMILY,
                                         labels=("graph",))
            good = sum(c.value for c in self._series(served, spec.graph))
            bad = (sum(c.value for c in self._series(shed, spec.graph)) +
                   sum(c.value for c in self._series(late, spec.graph)))
            return good, bad
        # quality: scores below the floor are the bad events; the shadow
        # histogram is unlabeled, so a graph-scoped quality spec still reads
        # the global distribution
        fam = self.registry.histogram(QUALITY_FAMILY, bounds=_UNIT_BUCKETS)
        hist = fam.get()
        bad = float(self._hist_below(hist, spec.objective, inclusive=False))
        return hist.count - bad, bad

    # ------------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One evaluation cycle: sample, window, alert."""
        now = self.time_fn() if now is None else now
        self._ticks.get().inc()
        for st in self._states.values():
            spec = st.spec
            good, bad = self._totals(spec)
            st.good_total, st.bad_total = good, bad
            samples = st.samples
            if not samples or now - samples[-1][0] >= self.resolution_s:
                samples.append((now, good, bad))
            horizon = now - spec.windows[-1]
            # keep one sample at/older than the horizon: it is the longest
            # window's baseline
            while len(samples) >= 2 and samples[1][0] <= horizon:
                samples.popleft()
            burns: Dict[float, float] = {}
            st.windows = {}
            for w in spec.windows:
                base = samples[0]
                for s in samples:
                    if s[0] <= now - w:
                        base = s
                    else:
                        break
                d_bad = bad - base[2]
                events = (good - base[1]) + d_bad
                if events < spec.min_events:
                    frac = burn = 0.0
                else:
                    frac = d_bad / events
                    burn = frac / spec.budget
                burns[w] = burn
                st.windows[w] = {"burn_rate": burn, "bad_fraction": frac,
                                 "events": events}
                self._burn.labels(slo=spec.name, window=f"{w:g}").set(burn)
            self._advance(st, burns, now)

    def _advance(self, st: _SpecState, burns: Dict[float, float],
                 now: float) -> None:
        spec = st.spec
        engage = ((burns[spec.fast_windows[0]] >= spec.fast_burn and
                   burns[spec.fast_windows[1]] >= spec.fast_burn) or
                  (burns[spec.slow_windows[0]] >= spec.slow_burn and
                   burns[spec.slow_windows[1]] >= spec.slow_burn))
        if st.state == "ok" and engage:
            self._transition(st, "burning", 1.0, "slo_burning", burns, now)
        elif st.state == "burning" and not engage and \
                burns[spec.fast_windows[0]] < spec.recover_burn and \
                burns[spec.slow_windows[0]] < spec.recover_burn:
            self._transition(st, "ok", 0.0, "slo_recovered", burns, now)

    def _transition(self, st: _SpecState, state: str, gauge: float,
                    event: str, burns: Dict[float, float],
                    now: float) -> None:
        spec = st.spec
        st.state = state
        st.transitions += 1
        self._state_g.labels(slo=spec.name).set(gauge)
        self._transitions.labels(slo=spec.name, state=state).inc()
        if self.recorder is not None:
            self.recorder.record_event(
                event, now, slo=spec.name, slo_kind=spec.kind,
                burn_fast=burns[spec.fast_windows[0]],
                burn_slow=burns[spec.slow_windows[0]],
                bad_total=st.bad_total, good_total=st.good_total)

    # ------------------------------------------------------------------
    def states(self) -> Dict[str, str]:
        return {name: st.state for name, st in self._states.items()}

    def burning(self) -> List[str]:
        return sorted(name for name, st in self._states.items()
                      if st.state == "burning")

    def burning_kinds(self) -> FrozenSet[str]:
        """The kinds currently burning — the admission controller's advisory
        signal (latency/shed push the degradation ladder; quality vetoes)."""
        return frozenset(st.spec.kind for st in self._states.values()
                         if st.state == "burning")

    def any_burning(self) -> bool:
        return any(st.state == "burning" for st in self._states.values())

    def status(self) -> Dict[str, object]:
        """JSON-ready evaluation snapshot — what ``GET /v1/slo`` serves.
        Reflects the last ``tick``; tick first for a fresh read."""
        specs = []
        for spec in self.specs:
            st = self._states[spec.name]
            specs.append({
                "name": spec.name,
                "kind": spec.kind,
                "graph": spec.graph,
                "objective": spec.objective,
                "budget": spec.budget,
                "state": st.state,
                "transitions": st.transitions,
                "good_total": st.good_total,
                "bad_total": st.bad_total,
                "windows": {f"{w:g}": dict(info)
                            for w, info in sorted(st.windows.items())},
            })
        return {
            "specs": specs,
            "burning": self.burning(),
            "ticks": int(self._ticks.get().value),
        }
