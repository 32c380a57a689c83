"""Service telemetry — the serving stack's counters, now on bounded storage.

Everything ``ServiceTelemetry`` records lives in a ``repro.obs``
``MetricsRegistry``: counters and gauges for the event/decision accounting,
exponential-bucket histograms for the latency/occupancy/quality
distributions (exact sums and counts → exact means), and fixed-size seeded
reservoirs for percentiles.  Memory is therefore O(1) in queries served —
the pre-PR unbounded per-wave lists (``wave_latencies_s``, ``shadow_scores``,
``wave_occupancies``, per-engine latency lists) leaked in any long-lived
server.  The one knob is ``reservoir_size`` (default 1024): while fewer
observations than that have arrived, a reservoir holds the *entire* history
and percentile summaries are exact; past it, percentiles degrade gracefully
to a deterministic uniform sample.

The legacy read surface is preserved: ``summary()`` emits the same keys with
the same values, and the old list/dict attributes (``wave_latencies_s``,
``shadow_scores``, ``served_by_precision``, ...) remain as read-only
properties reconstructed from the registry, exact for runs smaller than the
reservoir.  The registry itself is public (``telemetry.registry``) — it is
what ``GET /v1/metrics`` renders as Prometheus text exposition.

The occupancy counter is the serving-side view of the paper's κ-batching
economics: a wave amortizes one full edge-stream pass over its occupants, so
mean occupancy × κ is the effective amortization factor actually achieved
under real traffic (deadline flushes of partial waves lower it).

The autotune counters close the loop's observability: how many shadow
(float32 reference) evaluations were spent, what quality they measured, how
many iterations early-exit saved against the fixed budget (paper Fig. 7's
"additional 2x"), and which precisions traffic was actually served at — the
served-precision distribution is the live realization of Figs. 4-6's
quality/bit-width dial.

Per-stage wave timing (``record_stage``: plan / warm_start / iterate / topk
/ resolve, plus the pre-wave admission wait) is what finally says *where* a
query's milliseconds went rather than just how many there were — the
breakdown feeds ``summary()``'s ``stage_*`` keys, the bench JSON rows, and
``/v1/metrics``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry, exponential_buckets

# Mesh-layout key for waves on graphs registered without a mesh.  Defined here
# (the lowest layer that needs it) and re-exported by service.py; sharded
# graphs use "mesh:<axis>x<n_shards>" keys instead.
SINGLE_DEVICE_KEY = "single"

#: unit-interval bounds for occupancy/quality distributions
_UNIT_BUCKETS = tuple(i / 20 for i in range(1, 21))
#: iteration-count bounds (1..256 in doublings)
_ITER_BUCKETS = exponential_buckets(1.0, 2.0, 9)

#: wave pipeline stages timed by the service (`record_stage` accepts exactly
#: these — a typo'd stage must fail loudly, not mint a metric series)
WAVE_STAGES = ("plan", "warm_start", "iterate", "topk", "resolve")


class ServiceTelemetry:
    def __init__(self, reservoir_size: int = 1024) -> None:
        """``reservoir_size`` bounds every percentile sample (wave latency,
        per-engine latency, occupancy, shadow quality): percentiles are exact
        until that many observations, then a deterministic uniform sample."""
        self.reservoir_size = reservoir_size
        self.reset()

    def reset(self) -> None:
        """Zero every counter — e.g. after a jit warm-up pass, so measured
        telemetry reflects only the timed traffic without re-registering
        graphs (host-side partitioning and device uploads are not cheap)."""
        r = self.registry = MetricsRegistry(reservoir_size=self.reservoir_size)
        # -- waves / queries / cache ----------------------------------------
        self._waves = r.counter("ppr_waves_total", "Waves launched.")
        # graph-labeled: on a shared instance, one graph's overload must be
        # attributable (pairs with per-graph admission, ROADMAP item 3)
        self._queries = r.counter("ppr_queries_served_total",
                                  "Queries resolved by waves, per graph.",
                                  labels=("graph",))
        self._cache_hits = r.counter("ppr_cache_hits_total",
                                     "Submit-path result-cache hits.")
        self._cache_misses = r.counter("ppr_cache_misses_total",
                                       "Submit-path result-cache misses.")
        self._wave_latency = r.histogram(
            "ppr_wave_latency_seconds", "Wave wall-clock latency.")
        self._wave_latency_q = r.reservoir(
            "ppr_wave_latency_seconds_quantiles",
            "Wave latency percentile sample.")
        self._engine_latency = r.histogram(
            "ppr_engine_wave_latency_seconds",
            "Wave latency per concrete engine backend.", labels=("engine",))
        self._engine_latency_q = r.reservoir(
            "ppr_engine_wave_latency_seconds_quantiles",
            "Per-engine wave latency percentile sample.", labels=("engine",))
        self._occupancy = r.histogram(
            "ppr_wave_occupancy", "Wave occupancy (queries / kappa).",
            bounds=_UNIT_BUCKETS)
        self._occupancy_q = r.reservoir(
            "ppr_wave_occupancy_quantiles", "Wave occupancy sample.")
        self._served_by_precision = r.counter(
            "ppr_served_queries_total", "Queries served per precision.",
            labels=("precision",))
        self._waves_by_mesh = r.counter(
            "ppr_mesh_waves_total", "Waves per mesh layout.", labels=("mesh",))
        self._queries_by_mesh = r.counter(
            "ppr_mesh_queries_total", "Queries per mesh layout.",
            labels=("mesh",))
        # bounded precision-history ring (legacy `wave_precisions` list)
        self._wave_precisions = deque(maxlen=self.reservoir_size)
        # -- per-stage wave timing + admission wait -------------------------
        self._stage = r.histogram(
            "ppr_wave_stage_seconds",
            "Wave pipeline stage timing (plan/warm_start/iterate/topk/"
            "resolve).", labels=("stage",))
        self._admission_wait = r.histogram(
            "ppr_admission_wait_seconds",
            "Queue time between submit and wave launch.")
        self._admission_wait_q = r.reservoir(
            "ppr_admission_wait_seconds_quantiles",
            "Admission-wait percentile sample.")
        self._wave_iterations = r.histogram(
            "ppr_wave_iterations", "Iterations actually run per wave.",
            bounds=_ITER_BUCKETS)
        # -- adaptive-precision subsystem (repro.autotune) -------------------
        self._auto_resolved = r.counter(
            "ppr_auto_resolved_total",
            'precision="auto" resolutions per concrete format.',
            labels=("precision",))
        self._shadow_quality = r.histogram(
            "ppr_shadow_quality", "Shadow-scored quality (NDCG vs float32).",
            bounds=_UNIT_BUCKETS)
        self._shadow_quality_q = r.reservoir(
            "ppr_shadow_quality_quantiles", "Shadow quality sample.")
        self._early_exit_waves = r.counter(
            "ppr_early_exit_waves_total",
            "Waves stopped before their iteration budget.")
        self._iterations_saved = r.counter(
            "ppr_iterations_saved_total",
            "Iterations early exit saved vs the fixed budget.")
        # -- dynamic graph updates (repro.graph_updates) ---------------------
        self._deltas_applied = r.counter("ppr_deltas_applied_total",
                                         "Edge deltas absorbed.")
        self._edges_added = r.counter("ppr_delta_edges_added_total",
                                      "Edges inserted by deltas.")
        self._edges_removed = r.counter("ppr_delta_edges_removed_total",
                                        "Edges removed by deltas.")
        self._scoped_invalidations = r.counter(
            "ppr_scoped_invalidations_total",
            "Cache entries + pending queries dropped by delta frontiers.")
        self._scoped_cache_retained = r.counter(
            "ppr_scoped_cache_retained_total",
            "Cache entries a whole-graph flush would have lost.")
        self._warm_start_waves = r.counter("ppr_warm_start_waves_total",
                                           "Waves seeded from stored columns.")
        self._warm_start_columns = r.counter("ppr_warm_start_columns_total",
                                             "Personalization columns seeded.")
        self._warm_start_saved = r.counter(
            "ppr_warm_start_iterations_saved_total",
            "Iterations saved vs the last cold wave.")
        # -- async prefetcher ------------------------------------------------
        self._prefetch_issued = r.counter(
            "ppr_prefetch_issued_total", "Synthetic cache-warming queries.")
        self._prefetch_suppressed = r.counter(
            "ppr_prefetch_suppressed_total",
            "Idle polls that skipped prefetch: queue deep.")
        # -- HTTP serving control plane (repro.ppr_serving.http): admission
        # queue gauges plus every shed / degrade / batching decision — the
        # issue of record for "was quality traded, and did it recover"
        self._queue_depth = r.gauge(
            "ppr_queue_depth", "Pending queries in the admission queue "
            "(recorded on control ticks and on every submit).")
        self._oldest_wait = r.gauge(
            "ppr_oldest_wait_seconds",
            "Age of the longest-waiting pending query.")
        self._queries_shed = r.counter(
            "ppr_queries_shed_total",
            "Arrivals rejected by admission (429), per graph.",
            labels=("graph",))
        self._queries_deadline_shed = r.counter(
            "ppr_queries_deadline_shed_total",
            "Queries dropped at wave launch: admission wait already past "
            "their deadline (504), per graph.", labels=("graph",))
        # end-to-end admitted-query latency (submit → resolution), the
        # distribution the latency SLO evaluates; cache hits land as ~0
        self._query_latency = r.histogram(
            "ppr_query_latency_seconds",
            "Admitted-query latency, submit to resolution, per graph.",
            labels=("graph",))
        self._slo_advisory = r.counter(
            "ppr_slo_advisory_total",
            "Admission-ladder moves advised by SLO burn rather than queue "
            "depth (deepen/degrade/veto).", labels=("action",))
        self._shed_engaged = r.counter("ppr_shed_engaged_total",
                                       "High-water crossings (entering shed).")
        self._shed_recovered = r.counter("ppr_shed_recovered_total",
                                         "Low-water crossings (leaving shed).")
        self._slo_degrade = r.counter("ppr_slo_degrade_total",
                                      "Quality-target ceiling imposed.")
        self._slo_recover = r.counter("ppr_slo_recover_total",
                                      "Quality-target ceiling lifted.")
        self._slo_degraded_queries = r.counter(
            "ppr_slo_degraded_queries_total",
            "Auto queries resolved under a ceiling, per graph.",
            labels=("graph",))
        self._kappa_deepen = r.counter("ppr_kappa_deepen_total",
                                       "Wave depth deepened under load.")
        self._kappa_relax = r.counter("ppr_kappa_relax_total",
                                      "Wave depth relaxed toward base kappa.")
        # per-(graph, vertex) demand — what the prefetcher ranks hotness by —
        # plus each vertex's most recent (k, resolved precision), so a
        # prefetched entry lands under the cache key real traffic actually
        # probes (auto traffic records its post-resolution format).  Bounded
        # by DEMAND_COMPACT_THRESHOLD compaction, not by the registry.
        self.query_vertex_counts: Dict[str, Dict[int, int]] = {}
        self.query_vertex_last: Dict[str, Dict[int, Tuple[int, str]]] = {}

    # ------------------------------------------------------------------
    #: label value when a caller cannot attribute an event to a graph
    UNATTRIBUTED = "unknown"

    def record_wave(self, n_queries: int, kappa: int, latency_s: float,
                    precision: str, mesh_key: str = SINGLE_DEVICE_KEY,
                    engine: Optional[str] = None,
                    graph: str = UNATTRIBUTED) -> None:
        if engine is not None:
            self._engine_latency.labels(engine=engine).observe(latency_s)
            self._engine_latency_q.labels(engine=engine).add(latency_s)
        self._waves.get().inc()
        self._wave_latency.get().observe(latency_s)
        self._wave_latency_q.get().add(latency_s)
        occ = n_queries / float(kappa)
        self._occupancy.get().observe(occ)
        self._occupancy_q.get().add(occ)
        self._wave_precisions.append(precision)
        self._queries.labels(graph=graph).inc(n_queries)
        self._served_by_precision.labels(precision=precision).inc(n_queries)
        self._waves_by_mesh.labels(mesh=mesh_key).inc()
        self._queries_by_mesh.labels(mesh=mesh_key).inc(n_queries)

    def record_stage(self, stage: str, seconds: float) -> None:
        """One wave pipeline stage's wall-clock cost (see ``WAVE_STAGES``)."""
        if stage not in WAVE_STAGES:
            raise ValueError(f"unknown wave stage {stage!r} "
                             f"(have {WAVE_STAGES})")
        self._stage.labels(stage=stage).observe(seconds)

    def record_admission_wait(self, seconds: float) -> None:
        """One query's submit → wave-launch queue time."""
        self._admission_wait.get().observe(seconds)
        self._admission_wait_q.get().add(seconds)

    def record_wave_iterations(self, n: int) -> None:
        """Iterations one wave actually ran (early exit shortens this)."""
        self._wave_iterations.get().observe(n)

    def record_cache(self, hit: bool) -> None:
        (self._cache_hits if hit else self._cache_misses).get().inc()

    def record_auto_resolution(self, resolved_precision: str) -> None:
        """One ``precision="auto"`` query resolved to a concrete format."""
        self._auto_resolved.labels(precision=resolved_precision).inc()

    def record_shadow(self, score: float) -> None:
        """One shadow evaluation (float32 reference run + metric score)."""
        self._shadow_quality.get().observe(score)
        self._shadow_quality_q.get().add(score)

    def record_early_exit(self, iterations_saved: int) -> None:
        """A wave stopped ``iterations_saved`` iterations short of its budget."""
        self._early_exit_waves.get().inc()
        self._iterations_saved.get().inc(int(iterations_saved))

    #: per-graph demand entries above which counts are halved and pruned —
    #: bounds memory and ages out stale hotness (recency, not lifetime totals)
    DEMAND_COMPACT_THRESHOLD = 4096

    def record_query_vertex(self, graph: str, vertex: int,
                            k: Optional[int] = None,
                            pkey: Optional[str] = None) -> None:
        """One real (non-synthetic) query's demand for a personalization
        vertex — the frequency signal the prefetcher ranks."""
        counts = self.query_vertex_counts.setdefault(graph, {})
        counts[int(vertex)] = counts.get(int(vertex), 0) + 1
        if k is not None and pkey is not None:
            self.query_vertex_last.setdefault(graph, {})[int(vertex)] = \
                (int(k), pkey)
        if len(counts) > self.DEMAND_COMPACT_THRESHOLD:
            compacted = {v: n // 2 for v, n in counts.items() if n // 2}
            self.query_vertex_counts[graph] = compacted
            last = self.query_vertex_last.get(graph)
            if last is not None:
                self.query_vertex_last[graph] = \
                    {v: lk for v, lk in last.items() if v in compacted}

    def forget_graph_demand(self, graph: str) -> None:
        """Drop a graph's per-vertex demand signal (full re-registration:
        hotness measured on the dead topology must not steer the prefetcher)."""
        self.query_vertex_counts.pop(graph, None)
        self.query_vertex_last.pop(graph, None)

    def record_delta(self, edges_added: int, edges_removed: int,
                     cache_dropped: int, cache_retained: int,
                     pending_dropped: int) -> None:
        """One ``apply_delta``: scoped invalidation dropped ``cache_dropped``
        cache entries and ``pending_dropped`` pending queries, while
        ``cache_retained`` entries survived that a whole-graph flush (the old
        re-registration path) would have destroyed."""
        self._deltas_applied.get().inc()
        self._edges_added.get().inc(int(edges_added))
        self._edges_removed.get().inc(int(edges_removed))
        self._scoped_invalidations.get().inc(
            int(cache_dropped) + int(pending_dropped))
        self._scoped_cache_retained.get().inc(int(cache_retained))

    def record_warm_start(self, columns: int, iterations_saved: int) -> None:
        """One wave seeded ``columns`` personalization columns from stored
        converged state; ``iterations_saved`` is measured against the last
        cold wave of the same (graph, precision) stream."""
        self._warm_start_waves.get().inc()
        self._warm_start_columns.get().inc(int(columns))
        self._warm_start_saved.get().inc(int(iterations_saved))

    def record_prefetch(self, issued: int) -> None:
        """Synthetic cache-warming queries issued during an idle pump."""
        self._prefetch_issued.get().inc(int(issued))

    def record_prefetch_suppressed(self) -> None:
        """An idle poll skipped prefetch because the wave queue was deep —
        idle-only warming yielding to live traffic."""
        self._prefetch_suppressed.get().inc()

    # -- HTTP serving control plane ------------------------------------
    def record_queue_depth(self, depth: int, oldest_wait_s: float) -> None:
        """Admission-queue gauges (last + peak): sampled by the serving
        pump's control ticks *and* on every ``submit`` — peaks between
        control ticks used to be invisible under bursty arrivals."""
        self._queue_depth.get().set(int(depth))
        self._oldest_wait.get().set(float(oldest_wait_s))

    def record_shed(self, graph: str = UNATTRIBUTED) -> None:
        """One arriving query rejected by admission control (HTTP 429)."""
        self._queries_shed.labels(graph=graph).inc()

    def record_deadline_shed(self, graph: str = UNATTRIBUTED) -> None:
        """One query dropped at wave launch because its admission wait had
        already exceeded its deadline (HTTP 504) — serving it late would
        burn compute on an answer the caller stopped waiting for."""
        self._queries_deadline_shed.labels(graph=graph).inc()

    def record_query_latency(self, graph: str, seconds: float) -> None:
        """One admitted query's submit → resolution latency (cache hits
        record ~0) — the distribution the latency SLO is evaluated over."""
        self._query_latency.labels(graph=graph).observe(seconds)

    def record_slo_advisory(self, action: str) -> None:
        """The SLO monitor steered the admission ladder: ``deepen`` /
        ``degrade`` pushed by burn, or ``veto`` (quality burning blocked a
        degrade that queue depth alone would have taken)."""
        self._slo_advisory.labels(action=action).inc()

    def record_shed_transition(self, engaged: bool) -> None:
        """Load shedding switched on (high-water crossed) or off (drained
        below the low-water mark)."""
        (self._shed_engaged if engaged else self._shed_recovered).get().inc()

    def record_slo_transition(self, degraded: bool) -> None:
        """The SLO controller imposed (or lifted) the degraded quality-target
        ceiling on ``precision="auto"`` resolution."""
        (self._slo_degrade if degraded else self._slo_recover).get().inc()

    def record_degraded_query(self, graph: str = UNATTRIBUTED) -> None:
        """One auto query resolved against a stepped-down quality target."""
        self._slo_degraded_queries.labels(graph=graph).inc()

    def record_kappa_change(self, deepened: bool) -> None:
        """Backpressure batching moved the wave depth: deepened under load,
        or relaxed back toward the base κ as the queue drained."""
        (self._kappa_deepen if deepened else self._kappa_relax).get().inc()

    # ------------------------------------------------------------------
    # legacy read surface (everything below is derived from the registry)
    # ------------------------------------------------------------------
    @staticmethod
    def _labeled(family, cast=int) -> Dict[str, float]:
        return {labels[0][1]: cast(inst.value)
                for labels, inst in family.series()}

    @staticmethod
    def _family_total(family) -> int:
        """Sum across a labeled family's series — the legacy scalar view of a
        now-per-graph counter (a family with no series yet totals 0)."""
        return int(sum(inst.value for _, inst in family.series()))

    @property
    def waves(self) -> int:
        return int(self._waves.get().value)

    @property
    def queries_served(self) -> int:
        return self._family_total(self._queries)

    @property
    def queries_served_by_graph(self) -> Dict[str, int]:
        return self._labeled(self._queries)

    @property
    def cache_hits(self) -> int:
        return int(self._cache_hits.get().value)

    @property
    def cache_misses(self) -> int:
        return int(self._cache_misses.get().value)

    @property
    def wave_latencies_s(self) -> List[float]:
        """Percentile sample of wave latencies (exact history while shorter
        than ``reservoir_size``) — the bounded heir of the legacy list."""
        return self._wave_latency_q.get().values()

    @property
    def wave_occupancies(self) -> List[float]:
        return self._occupancy_q.get().values()

    @property
    def wave_precisions(self) -> List[str]:
        return list(self._wave_precisions)

    @property
    def wave_latencies_by_engine(self) -> Dict[str, List[float]]:
        return {labels[0][1]: inst.values()
                for labels, inst in self._engine_latency_q.series()}

    @property
    def shadow_scores(self) -> List[float]:
        return self._shadow_quality_q.get().values()

    @property
    def served_by_precision(self) -> Dict[str, int]:
        return self._labeled(self._served_by_precision)

    @property
    def auto_resolved(self) -> Dict[str, int]:
        return self._labeled(self._auto_resolved)

    @property
    def waves_by_mesh(self) -> Dict[str, int]:
        return self._labeled(self._waves_by_mesh)

    @property
    def queries_by_mesh(self) -> Dict[str, int]:
        return self._labeled(self._queries_by_mesh)

    @property
    def shadow_evaluations(self) -> int:
        return self._shadow_quality.get().count

    @property
    def early_exit_waves(self) -> int:
        return int(self._early_exit_waves.get().value)

    @property
    def iterations_saved(self) -> int:
        return int(self._iterations_saved.get().value)

    @property
    def deltas_applied(self) -> int:
        return int(self._deltas_applied.get().value)

    @property
    def edges_added(self) -> int:
        return int(self._edges_added.get().value)

    @property
    def edges_removed(self) -> int:
        return int(self._edges_removed.get().value)

    @property
    def scoped_invalidations(self) -> int:
        return int(self._scoped_invalidations.get().value)

    @property
    def scoped_cache_retained(self) -> int:
        return int(self._scoped_cache_retained.get().value)

    @property
    def warm_start_waves(self) -> int:
        return int(self._warm_start_waves.get().value)

    @property
    def warm_start_columns(self) -> int:
        return int(self._warm_start_columns.get().value)

    @property
    def warm_start_iterations_saved(self) -> int:
        return int(self._warm_start_saved.get().value)

    @property
    def prefetch_issued(self) -> int:
        return int(self._prefetch_issued.get().value)

    @property
    def prefetch_suppressed(self) -> int:
        return int(self._prefetch_suppressed.get().value)

    @property
    def queue_depth_last(self) -> int:
        return int(self._queue_depth.get().value)

    @property
    def queue_depth_peak(self) -> int:
        return int(self._queue_depth.get().peak)

    @property
    def oldest_wait_last_s(self) -> float:
        return self._oldest_wait.get().value

    @property
    def oldest_wait_peak_s(self) -> float:
        return self._oldest_wait.get().peak

    @property
    def queries_shed(self) -> int:
        return self._family_total(self._queries_shed)

    @property
    def queries_shed_by_graph(self) -> Dict[str, int]:
        return self._labeled(self._queries_shed)

    @property
    def queries_deadline_shed(self) -> int:
        return self._family_total(self._queries_deadline_shed)

    @property
    def queries_deadline_shed_by_graph(self) -> Dict[str, int]:
        return self._labeled(self._queries_deadline_shed)

    @property
    def slo_advisories(self) -> Dict[str, int]:
        return self._labeled(self._slo_advisory)

    @property
    def shed_engaged_events(self) -> int:
        return int(self._shed_engaged.get().value)

    @property
    def shed_recovered_events(self) -> int:
        return int(self._shed_recovered.get().value)

    @property
    def slo_degrade_events(self) -> int:
        return int(self._slo_degrade.get().value)

    @property
    def slo_recover_events(self) -> int:
        return int(self._slo_recover.get().value)

    @property
    def slo_degraded_queries(self) -> int:
        return self._family_total(self._slo_degraded_queries)

    @property
    def slo_degraded_queries_by_graph(self) -> Dict[str, int]:
        return self._labeled(self._slo_degraded_queries)

    @property
    def kappa_deepen_events(self) -> int:
        return int(self._kappa_deepen.get().value)

    @property
    def kappa_relax_events(self) -> int:
        return int(self._kappa_relax.get().value)

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        lat = np.asarray(self.wave_latencies_s, np.float64)
        # the histogram's sum/count cover *every* wave ever (the reservoir
        # may be a sample); totals and means stay exact under eviction
        total_s = self._wave_latency.get().sum
        cache_total = self.cache_hits + self.cache_misses
        occ = self._occupancy.get()
        shadow = self._shadow_quality.get()
        out = {
            "waves": self.waves,
            "queries_served": self.queries_served,
            "queries_per_s": self.queries_served / total_s if total_s else 0.0,
            "wave_latency_p50_s": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "wave_latency_p95_s": float(np.percentile(lat, 95)) if lat.size else 0.0,
            "mean_occupancy": occ.mean,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hits / cache_total if cache_total else 0.0,
            "shadow_evaluations": self.shadow_evaluations,
            "shadow_quality_mean": shadow.mean,
            "early_exit_waves": self.early_exit_waves,
            "iterations_saved": self.iterations_saved,
            "deltas_applied": self.deltas_applied,
            "edges_added": self.edges_added,
            "edges_removed": self.edges_removed,
            "scoped_invalidations": self.scoped_invalidations,
            "scoped_cache_retained": self.scoped_cache_retained,
            "warm_start_waves": self.warm_start_waves,
            "warm_start_columns": self.warm_start_columns,
            "warm_start_iterations_saved": self.warm_start_iterations_saved,
            "prefetch_issued": self.prefetch_issued,
            "prefetch_suppressed": self.prefetch_suppressed,
            "queue_depth": self.queue_depth_last,
            "queue_depth_peak": self.queue_depth_peak,
            "oldest_wait_s": self.oldest_wait_last_s,
            "oldest_wait_peak_s": self.oldest_wait_peak_s,
            "queries_shed": self.queries_shed,
            "queries_deadline_shed": self.queries_deadline_shed,
            "shed_engaged_events": self.shed_engaged_events,
            "shed_recovered_events": self.shed_recovered_events,
            "slo_degrade_events": self.slo_degrade_events,
            "slo_recover_events": self.slo_recover_events,
            "slo_degraded_queries": self.slo_degraded_queries,
            "kappa_deepen_events": self.kappa_deepen_events,
            "kappa_relax_events": self.kappa_relax_events,
        }
        for pkey, n in sorted(self.served_by_precision.items()):
            out[f"served_{pkey}"] = n
        for pkey, n in sorted(self.auto_resolved.items()):
            out[f"auto_{pkey}"] = n
        for mkey, n in sorted(self.waves_by_mesh.items()):
            out[f"waves_{mkey}"] = n
        for mkey, n in sorted(self.queries_by_mesh.items()):
            out[f"queries_{mkey}"] = n
        for ekey, stats in sorted(self.engine_stats().items()):
            for stat, v in stats.items():
                out[f"engine_{ekey}_{stat}"] = v
        for stage, stats in sorted(self.stage_stats().items()):
            out[f"stage_{stage}_total_s"] = stats["total_s"]
            out[f"stage_{stage}_mean_s"] = stats["mean_s"]
        aw = self._admission_wait.get()
        if aw.count:
            out["admission_wait_mean_s"] = aw.mean
            out["admission_wait_p95_s"] = \
                self._admission_wait_q.get().percentile(95)
        return out

    def engine_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-engine wave-latency stats: count / mean / p95 per concrete
        engine key — the observability of the backend layer (which datapath
        served what, and how fast).  Count and mean come from the histogram
        (exact forever); p95 from the bounded reservoir sample."""
        out: Dict[str, Dict[str, float]] = {}
        samples = {labels[0][1]: inst
                   for labels, inst in self._engine_latency_q.series()}
        for labels, hist in self._engine_latency.series():
            ekey = labels[0][1]
            sample = samples.get(ekey)
            vals = np.asarray(sample.values() if sample else [], np.float64)
            out[ekey] = {
                "waves": int(hist.count),
                "latency_mean_s": hist.mean,
                "latency_p95_s": float(np.percentile(vals, 95))
                if vals.size else 0.0,
            }
        return out

    def stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-stage wave timing (count / total / mean) — where a wave's
        milliseconds go: plan vs iterate vs top-K vs resolve."""
        out: Dict[str, Dict[str, float]] = {}
        for labels, hist in self._stage.series():
            if not hist.count:
                continue
            out[labels[0][1]] = {
                "count": int(hist.count),
                "total_s": hist.sum,
                "mean_s": hist.mean,
            }
        return out
