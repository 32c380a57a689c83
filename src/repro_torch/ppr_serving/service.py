"""`PPRService` — the futures-based query front-end over the engine backends.

Counterpart of ``repro.ppr_serving.service``.  Lifecycle: graphs are
registered once onto an engine family (host arrays moved to the service's
device, edge stream padded to packets, per-format quantized values cached),
then queries flow through

    submit → precision resolution ("auto" → controller) → result cache probe
           → PPRFuture (resolved immediately on a hit; else queued)
           → κ-batch scheduler → wave launch → engine plan (step + iterate +
             early-exit + top-K) → cache fill → shadow quality feedback
           → futures resolve

A wave shares one edge stream over up to κ personalization columns (the
paper's κ-batching).  Results are ranked ``Recommendation``s — the query
vertex itself is always excluded from its own top-k.

``precision="auto"`` queries are resolved to a concrete format *before wave
admission* by the adaptive-precision controller
(``repro_torch.autotune.controller``), so auto traffic batches into the same
waves as explicit same-format traffic.  After a fixed-precision wave, a
sampled fraction of its auto queries is shadow-scored against a float32
reference run of the graph's own float engine over only the sampled columns
(on the "fused" family, the fused-iteration kernel), keeping the
controller's quality estimates current (paper Figs. 4-6 measured online).
``prefetch`` arms the idle-poll cache warmer
(``repro_torch.ppr_serving.prefetch``).

``apply_delta`` absorbs an edge delta into a live graph (epoch bump, scoped
invalidation, the armed engines' device refresh), and ``warm_start`` seeds
waves from each vertex's last converged column (``repro_torch.graph_updates``).

``tracing``/``slo``/``otlp`` arm the observability layer
(``repro_torch.obs``): per-query and per-wave span traces into the flight
recorder and an OTLP exporter, and SLO burn rates over the telemetry
registry.  ``set_kappa`` and ``export_telemetry`` are the hooks the HTTP
tier's admission controller and pump drive (``repro_torch.ppr_serving.http``).

``register_graph(mesh=...)`` partitions a graph by destination range over
a ``repro_torch.launch.mesh.Mesh`` (engine family "sharded"): each shard's
SpMV runs on its device, the combine and top-K on the mesh's controller.

Not ported, each raising ``NotImplementedError``: the deprecated
``serve``/``pump``/``drain``.
"""
from __future__ import annotations

import dataclasses
import functools
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.autotune.controller import AutotuneConfig, PrecisionController
from repro_torch.autotune.convergence import ConvergencePolicy
from repro_torch.core.fixed_point import PAPER_FORMATS, QFormat, format_for_bits
from repro_torch.core.metrics import ranking
from repro_torch.device import resolve_device
from repro_torch.graph_updates.delta import EdgeDelta
from repro_torch.graph_updates.warmstart import WarmStartStore
from repro_torch.obs import FlightRecorder, Tracer, fanout_sink
from repro_torch.obs import trace as _trace
from repro_torch.obs.otlp import OTLPExporter
from repro_torch.obs.slo import SLOMonitor, SLOSpec, default_slo_specs
from repro_torch.ppr_serving.cache import LRUCache
from repro_torch.ppr_serving.engine import engine_families, engine_for, family_members
from repro_torch.ppr_serving.futures import PPRFuture, QueryRejected
from repro_torch.ppr_serving.graphs import RegisteredGraph
from repro_torch.ppr_serving.prefetch import PrefetchConfig, Prefetcher
from repro_torch.ppr_serving.scheduler import Wave, WaveScheduler
from repro_torch.ppr_serving.telemetry import ServiceTelemetry

Precision = Union[None, int, str, QFormat]

FLOAT_KEY = "f32"
AUTO_KEY = "auto"

# timeline spans (``repro_torch.obs.trace.Timeline``), timed on their own
# perf-counter reads: never through ``time_fn``
_ns = time.perf_counter_ns
(_SUBMIT, _ADMIT, _WAVE, _PLAN, _ITERATE, _TOPK, _DEVICE_WAIT, _RESOLVE,
 _CALLBACKS) = (
    _trace.span_id(n) for n in (
        "ppr.submit", "ppr.admit", "ppr.wave", "ppr.wave.plan", "ppr.wave.iterate",
        "ppr.wave.topk", "ppr.wave.device_wait", "ppr.wave.resolve",
        "ppr.wave.callbacks"))


def _admit(pop, *args, **kwargs):
    """The scheduler's ``pop(*args, **kwargs)``, timed as ``ppr.admit`` when
    a timeline is armed."""
    tl = _trace.armed
    if tl is None:
        return pop(*args, **kwargs)
    t0 = _ns()
    popped = pop(*args, **kwargs)
    tl.record(_ADMIT, t0, _ns())
    return popped


def normalize_precision(precision: Precision) -> Optional[QFormat]:
    """None/"f32" → float32 path; int bits / "Q1.f" / QFormat → fixed path."""
    if precision == AUTO_KEY:
        raise ValueError('precision="auto" must be resolved by the service\'s '
                         'precision controller before normalization')
    if precision is None or precision == FLOAT_KEY:
        return None
    if isinstance(precision, QFormat):
        return precision
    if isinstance(precision, int):
        return format_for_bits(precision)
    if isinstance(precision, str):
        if precision in PAPER_FORMATS:
            return PAPER_FORMATS[precision]
        if precision.startswith("Q") and precision.count(".") == 1:
            i, f = precision[1:].split(".")
            try:
                return QFormat(int(i), int(f))
            except ValueError:
                pass   # malformed digits ("Q1.25x") → the descriptive error
    raise ValueError(f"unknown precision spec: {precision!r}")


def precision_key(precision: Precision) -> str:
    fmt = normalize_precision(precision)
    return FLOAT_KEY if fmt is None else fmt.name


@dataclasses.dataclass(frozen=True)
class PPRQuery:
    """One recommendation request.

    ``deadline`` bounds how long the query may wait in the admission queue for
    its wave to fill (seconds); it does not bound the iteration time itself.

    ``precision="auto"`` asks the service's precision controller for the
    cheapest Q format currently meeting ``quality_target`` (NDCG against the
    float32 reference; the controller's default target when None).
    ``quality_target`` is ignored for explicit precisions.
    """
    graph: str
    vertex: int
    k: int = 10
    precision: Precision = None
    deadline: Optional[float] = None
    quality_target: Optional[float] = None
    # synthetic cache-warming query issued by the prefetcher: computed and
    # cached like real traffic, but never counted in the query-latency
    # telemetry
    prefetch: bool = False


@dataclasses.dataclass
class Recommendation:
    query: PPRQuery
    vertices: np.ndarray           # [k] ranked vertex ids (self excluded)
    scores: np.ndarray             # [k] float scores (dequantized for fixed)
    source: str                    # "wave" | "cache"
    wave_id: int = -1
    latency_s: float = 0.0
    precision: str = ""            # resolved precision key ("f32" / "Q1.f")


class PPRService:
    """Facade: named graphs on engine backends, κ-batched admission,
    futures-based results, an LRU result cache, adaptive precision
    (``precision="auto"``), early-exit iterations, live edge deltas, warm
    start and the idle-poll prefetcher, on one device (``device="cuda"``
    unless the caller asks for the CPU).

    ``autotune`` configures the precision controller (an ``AutotuneConfig``;
    the controller is always built, with the defaults when None).
    ``warm_start`` seeds wave iterations from each personalization vertex's
    last converged column (True, or an int store capacity per graph) — pair
    it with ``early_exit`` so the shorter convergence distance actually
    saves iterations.  The columns live on the host: a warm wave copies its
    final state to the host once.  ``prefetch`` arms the idle-poll cache
    warmer (True, or a ``PrefetchConfig``).

    ``tracing`` arms per-query/per-wave span traces (completed traces land in
    ``self.recorder``); ``True`` traces everything, a float in (0, 1)
    head-samples that fraction of queries with a seeded RNG (one draw a
    query; a wave trace is kept when any occupant is sampled).  A traced
    wave's ``iterate`` span carries ``iterations_run``, ``budget``,
    ``early_exit`` and, under an early-exit policy, the last checked
    ``residual``.  ``slo`` arms the burn-rate monitor (``True`` for the
    default specs, a spec sequence, or a prebuilt ``SLOMonitor`` over this
    service's telemetry registry); ``otlp`` attaches an ``OTLPExporter`` that
    receives completed traces beside the flight recorder and metric pushes
    from ``export_telemetry()``.  All three default off, and then cost one
    ``is None`` check a query."""

    def __init__(
        self,
        kappa: int = 8,
        iterations: int = 10,
        alpha: float = 0.85,
        max_wait: float = 0.0,
        cache_capacity: int = 4096,
        topk_tile: Optional[int] = None,
        autotune: Optional[AutotuneConfig] = None,
        early_exit: Union[None, bool, ConvergencePolicy] = None,
        warm_start: Union[bool, int] = False,
        prefetch: Union[None, bool, PrefetchConfig] = None,
        tracing: Union[bool, float] = False,
        reservoir_size: int = 1024,
        time_fn=time.monotonic,
        slo: Union[None, bool, Sequence[SLOSpec], SLOMonitor] = None,
        otlp: Optional[OTLPExporter] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.kappa = kappa
        self.iterations = iterations
        self.alpha = alpha
        self.topk_tile = topk_tile
        self.time_fn = time_fn
        self.scheduler = WaveScheduler(kappa, max_wait=max_wait, time_fn=time_fn)
        self.cache = LRUCache(cache_capacity)
        self.telemetry = ServiceTelemetry(reservoir_size=reservoir_size)
        self.recorder = FlightRecorder()
        # tracing=True → rate 1.0; a float is a head-sampling rate.  bool is
        # checked first: True/False are ints.
        rate = (1.0 if tracing is True else
                0.0 if tracing is False else float(tracing))
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"tracing rate must be in [0, 1], got {tracing}")
        self._trace_rate = rate
        # seeded: a replayed run samples the same queries
        self._trace_rng = random.Random(0)
        self.otlp = otlp
        if otlp is not None and otlp._mirror is None:
            otlp.bind_registry(self.telemetry.registry)
        sink = self.recorder.record_trace if otlp is None else \
            fanout_sink(self.recorder.record_trace, otlp.record_trace)
        self.tracer: Optional[Tracer] = (
            Tracer(time_fn=time_fn, sink=sink) if rate > 0.0 else None)
        if slo is None or slo is False:
            self.slo: Optional[SLOMonitor] = None
        elif isinstance(slo, SLOMonitor):
            self.slo = slo
        else:
            specs = default_slo_specs() if slo is True else tuple(slo)
            self.slo = SLOMonitor(self.telemetry.registry, specs,
                                  time_fn=time_fn, recorder=self.recorder)
        self.controller = PrecisionController(autotune or AutotuneConfig())
        if early_exit is True:
            self.convergence: Optional[ConvergencePolicy] = ConvergencePolicy()
        else:
            self.convergence = early_exit or None
        if warm_start is True:
            self._warm: Optional[WarmStartStore] = WarmStartStore()
        elif warm_start:
            self._warm = WarmStartStore(capacity_per_graph=int(warm_start))
        else:
            self._warm = None
        if prefetch is True:
            self.prefetcher: Optional[Prefetcher] = Prefetcher(time_fn=time_fn)
        elif prefetch:
            self.prefetcher = Prefetcher(prefetch, time_fn=time_fn)
        else:
            self.prefetcher = None
        self._graphs: Dict[str, RegisteredGraph] = {}
        self._wave_counter = 0
        # Guards the quick mutation sections (scheduler, cache, controller,
        # deltas, wave bookkeeping), so the HTTP pump can drive poll()/flush()
        # on its worker thread while the event-loop thread calls submit();
        # engine compute runs outside it.  RLock: PPRFuture.result()
        # re-enters through _drive on the same thread.
        self._lock = threading.RLock()
        # last cold (unseeded) iteration count per (graph, precision): the
        # baseline warm_start_iterations_saved is measured against
        self._cold_iters: Dict[Tuple[str, str], int] = {}

    # ------------------------------------------------------------------
    def register_graph(self, name: str, g, formats: Sequence[Precision] = (),
                       packet: int = 256, mesh=None,
                       mesh_axis: Optional[str] = None,
                       engine: Optional[str] = None) -> RegisteredGraph:
        """Register a graph onto an engine family; optionally pre-quantize.

        ``engine`` names the backend family serving the graph's waves:
        "single" (plain PyTorch over the full edge stream), "fused" (the
        fused-iteration kernel) or "sharded", which partitions the edges by
        destination range over ``mesh``/``mesh_axis`` (a
        ``launch.mesh.Mesh`` of the service's device type; same results —
        bit-identical on the fixed path; ``num_vertices`` need not divide
        the shard count).  Default: "sharded" when a mesh is given, else
        "single".  Re-registering an existing name invalidates that graph's
        cached results, rejects its still-pending futures and resets its
        quality estimates — nothing from the old topology may be served or
        steer the precision ladder."""
        with self._lock:
            return self._register_graph_locked(name, g, formats, packet,
                                               mesh, mesh_axis, engine)

    def _register_graph_locked(self, name, g, formats, packet, mesh,
                               mesh_axis, engine) -> RegisteredGraph:
        family = engine if engine is not None else \
            ("sharded" if mesh is not None else "single")
        if family not in engine_families():
            raise ValueError(f"unknown engine family {family!r} "
                             f"(have {list(engine_families())})")
        # family-level metadata resolves through any member: fixed-only
        # plug-in families are legal and must be able to register
        members = family_members(family)
        needs_mesh = members[0].needs_mesh
        if needs_mesh and mesh is None:
            raise ValueError(f"engine {family!r} needs a mesh= at registration")
        if not needs_mesh and mesh is not None:
            raise ValueError(f"engine {family!r} runs single-device — drop "
                             f"mesh= or pick a sharded family "
                             f"(have {list(engine_families())})")
        if mesh is not None and mesh.controller.type != self.device.type:
            raise ValueError(f"the mesh's devices are {mesh.controller.type}, "
                             f"the service runs on {self.device}")
        if name in self._graphs:
            self.cache.invalidate(lambda key: key[0] == name)
            for _key, fut, _t, _d in self.scheduler.extract(
                    lambda k: k[0] == name):
                fut._reject(QueryRejected(
                    f"graph {name!r} was re-registered: the pending query for "
                    f"vertex {fut.query.vertex} was validated against the old "
                    f"topology and cannot be served — resubmit it against the "
                    f"new graph", code="graph-replaced"))
                self._finish_rejected(fut, "graph-replaced")
            self.recorder.record_event("graph_replaced", self.time_fn(),
                                       graph=name)
            self.controller.forget_graph(name)
            if self._warm is not None:
                self._warm.drop_graph(name)
            if self.prefetcher is not None:
                self.prefetcher.drop_graph(name)
            self.telemetry.forget_graph_demand(name)
        rg: RegisteredGraph = members[0].make_graph(
            name, g, packet=packet, mesh=mesh, mesh_axis=mesh_axis,
            device=self.device)
        rg.engine_family = family
        if not members[0].fixed:          # float member present: prepare it
            members[0].prepare(rg)
            rg.arm(members[0])
        for p in formats:
            fmt = normalize_precision(p)
            if fmt is not None:
                fixed_engine = engine_for(family, True)
                fixed_engine.prepare(rg, fmt)
                rg.arm(fixed_engine)
        self._graphs[name] = rg
        return rg

    @property
    def graphs(self) -> Tuple[str, ...]:
        return tuple(self._graphs)

    def registered_graph(self, name: str) -> RegisteredGraph:
        """The live registered-graph state (its ``.source`` is the current
        host ``COOGraph`` — the base external drivers synthesize deltas
        against)."""
        if name not in self._graphs:
            raise KeyError(f"graph {name!r} is not registered "
                           f"(have {list(self._graphs)})")
        return self._graphs[name]

    def apply_delta(self, name: str, delta: EdgeDelta) -> Dict[str, float]:
        """Absorb an edge delta into a live registered graph — no
        stop-the-world re-registration.

        The graph's epoch is bumped (cache keys and wave keys are
        epoch-tagged), and invalidation is *scoped*: only cache entries and
        pending futures whose personalization vertex falls in the delta's
        affected frontier (touched vertices plus their in-neighbors — the
        one-hop, α-weighted blast radius) are dropped.  Everything else is
        retagged to the new epoch and keeps serving: entries outside the
        frontier see only multi-hop, α²-damped rank shifts, a bounded
        staleness.  Surviving pending futures move to the new epoch's wave
        keys with their admission budgets intact — they resolve against the
        new topology.  Frontier futures are *rejected* with a descriptive
        ``QueryRejected`` (never left forever-pending).  Autotune quality
        windows decay (soft evidence) rather than reset, and the hot
        vertices whose cache entries were dropped join the prefetcher's
        re-warm queue.  The host merge is followed by each armed engine's
        device refresh (incremental requantization upload; on the fused
        family the dirty blocks re-packetized and a new dst stream
        uploaded), so the delta pays its device cost here.  A wave planned
        before the delta finishes on the tensors its plan bound and caches
        under its own epoch.

        Returns a report dict (also folded into telemetry): epoch, edge
        counts, scoped-invalidation accounting, apply latency."""
        with self._lock:  # a delta must not race a wave's bookkeeping
            return self._apply_delta_locked(name, delta)

    def _apply_delta_locked(self, name: str, delta: EdgeDelta) -> Dict[str, float]:
        if name not in self._graphs:
            raise KeyError(f"graph {name!r} is not registered "
                           f"(have {list(self._graphs)})")
        rg = self._graphs[name]
        t0 = self.time_fn()
        frontier = delta.affected_frontier(rg.source)
        fr = frozenset(int(v) for v in frontier)
        info = rg.apply_delta(delta)
        for eng in rg.armed_engines():
            eng.on_delta(rg, info)
        epoch = rg.epoch

        dropped_vertices: List[int] = []

        def retag(key):
            if key[0] != name:
                return key
            if int(key[2]) in fr:
                dropped_vertices.append(int(key[2]))
                return None
            return (key[0], epoch) + tuple(key[2:])

        cache_dropped, cache_retained = self.cache.remap(retag)
        moved = self.scheduler.extract(lambda k: k[0] == name)
        pending_dropped = pending_requeued = 0
        for key, fut, enqueued_at, deadline in moved:
            if int(fut.query.vertex) in fr:
                pending_dropped += 1
                fut._reject(QueryRejected(
                    f"pending query for vertex {fut.query.vertex} on graph "
                    f"{name!r} was invalidated by an edge delta (epoch "
                    f"{epoch}): its personalization vertex is inside the "
                    f"delta's affected frontier — resubmit to recompute on "
                    f"the new topology", code="delta-invalidated"))
                self._finish_rejected(fut, "delta-invalidated")
            else:
                new_key = (key[0], key[1], key[2], epoch)
                fut._wave_key = new_key
                self.scheduler.submit(new_key, fut, deadline=deadline,
                                      now=enqueued_at)
                pending_requeued += 1
        if self._warm is not None:
            self._warm.grow(name, rg.num_vertices)
        self.controller.decay_graph(name)
        if self.prefetcher is not None:
            counts = self.telemetry.query_vertex_counts.get(name, {})
            hot = [v for v in dropped_vertices
                   if counts.get(v, 0) >= self.prefetcher.config.min_count]
            self.prefetcher.note_invalidated(name, hot)
        self.telemetry.record_delta(delta.num_added, delta.num_removed,
                                    cache_dropped, cache_retained,
                                    pending_dropped)
        self.recorder.record_event(
            "delta", self.time_fn(), graph=name, epoch=epoch,
            edges_added=delta.num_added, edges_removed=delta.num_removed,
            cache_dropped=cache_dropped, pending_dropped=pending_dropped)
        return {
            "epoch": epoch,
            "edges_added": delta.num_added,
            "edges_removed": delta.num_removed,
            "num_vertices": rg.num_vertices,
            "frontier_size": len(fr),
            "cache_dropped": cache_dropped,
            "cache_retained": cache_retained,
            "pending_dropped": pending_dropped,
            "pending_requeued": pending_requeued,
            "apply_s": self.time_fn() - t0,
        }

    # ------------------------------------------------------------------
    def queue_depth(self) -> int:
        """Pending queries across every wave key — O(1)."""
        return self.scheduler.queue_depth()

    def oldest_wait_s(self, now: Optional[float] = None) -> float:
        """Seconds the longest-waiting pending query has been queued."""
        return self.scheduler.oldest_wait_s(now)

    def set_kappa(self, kappa: int) -> None:
        """Retune the wave batch depth in place (deepen κ under load to
        amortize one edge-stream pass over more queries before shedding;
        relax it as the queue drains).  Applies to waves formed after the
        call — already-queued queries launch at the new depth.  Nothing on
        the device is sized by κ: each wave allocates its own [V, κ] state,
        and the fused kernel takes any κ (κ % 4 == 0 runs its four-wide
        template)."""
        if kappa < 1:
            raise ValueError(f"kappa must be >= 1, got {kappa}")
        with self._lock:
            if kappa == self.kappa:
                return
            self.telemetry.record_kappa_change(deepened=kappa > self.kappa)
            self.recorder.record_event(
                "kappa", self.time_fn(), kappa=kappa,
                deepened=kappa > self.kappa, previous=self.kappa)
            self.kappa = kappa
            self.scheduler.kappa = kappa

    def degrade_quality(self, target: float) -> None:
        """Impose the SLO-degradation ceiling: until ``restore_quality``,
        every ``precision="auto"`` query resolves against
        ``min(its target, target)`` — serving 0.93 instead of 0.95 when the
        admission queue is deep buys wave latency at a measured, recorded
        quality cost (each capped resolution counts in telemetry)."""
        with self._lock:
            if self.controller.target_ceiling == float(target):
                return
            self.controller.set_target_ceiling(target)
            self.telemetry.record_slo_transition(degraded=True)
            self.recorder.record_event("slo_degrade", self.time_fn(),
                                       target=float(target))

    def restore_quality(self) -> None:
        """Lift the degradation ceiling (queue drained) — auto traffic
        resumes its requested quality targets."""
        with self._lock:
            if self.controller.target_ceiling is None:
                return
            self.controller.set_target_ceiling(None)
            self.telemetry.record_slo_transition(degraded=False)
            self.recorder.record_event("slo_recover", self.time_fn())

    # ------------------------------------------------------------------
    def _trace_sampled(self) -> bool:
        """Head-sampling decision for one query — exactly one seeded RNG
        draw at rates below 1.0, no draw at full tracing."""
        return self._trace_rate >= 1.0 or \
            self._trace_rng.random() < self._trace_rate

    def export_telemetry(self) -> int:
        """Drive the attached OTLP exporter one cycle (queued span batches +
        a delta metrics push when due); returns POSTs made, 0 with no
        exporter.  The serving pump calls this off the event loop."""
        if self.otlp is None:
            return 0
        return self.otlp.tick(self.telemetry.registry)

    # ------------------------------------------------------------------
    def _resolve_precision(self, q: PPRQuery) -> str:
        """Concrete precision key for a query; "auto" goes through the ladder."""
        if q.precision == AUTO_KEY:
            ceiling = self.controller.target_ceiling
            if ceiling is not None:
                requested = (self.controller.config.default_target
                             if q.quality_target is None
                             else float(q.quality_target))
                if ceiling < requested:
                    self.telemetry.record_degraded_query(graph=q.graph)
            fmt = self.controller.resolve(q.graph, q.quality_target)
            pkey = FLOAT_KEY if fmt is None else fmt.name
            self.telemetry.record_auto_resolution(pkey)
            return pkey
        return precision_key(q.precision)

    def _cache_key(self, q: PPRQuery, pkey: str,
                   epoch: Optional[int] = None) -> Tuple:
        # graph epoch + resolved precision + iteration budget + early-exit +
        # warm-start mode: a result computed on an older topology or under
        # different numerics must never alias a current entry.  Scoped delta
        # invalidation relies on this layout (epoch at [1], vertex at [2]).
        # Wave resolution passes the wave's own epoch: a delta can land
        # while a wave computes outside the lock, and the current epoch
        # would file the stale wave's results under the new one.
        if epoch is None:
            epoch = getattr(self._graphs.get(q.graph), "epoch", 0)
        return (q.graph, epoch, int(q.vertex), pkey,
                int(q.k), int(self.iterations), self.convergence is not None,
                self._warm is not None)

    # ------------------------------------------------------------------
    # futures API
    # ------------------------------------------------------------------
    def submit(self, q: PPRQuery) -> PPRFuture:
        """One query in, one ``PPRFuture`` out.

        A cache hit resolves the future before this returns; a miss queues
        the future for the next wave on its (graph, precision, mesh, epoch)
        stream.  Validation happens here and raises synchronously: one bad
        query must never poison a wave."""
        tl = _trace.armed
        t_sub = _ns() if tl is not None else 0
        if q.graph not in self._graphs:
            raise KeyError(f"graph {q.graph!r} is not registered "
                           f"(have {list(self._graphs)})")
        rg = self._graphs[q.graph]
        if not 0 <= q.vertex < rg.num_vertices:
            raise ValueError(f"vertex {q.vertex} out of range for {q.graph!r}")
        if q.k < 1:
            raise ValueError(f"k must be >= 1, got {q.k}")
        if q.k > rg.num_vertices - 1:
            # self-exclusion means at most V-1 recommendable vertices
            raise ValueError(
                f"k={q.k} exceeds the {rg.num_vertices - 1} recommendable "
                f"vertices of {q.graph!r} (|V|={rg.num_vertices}, the query "
                f"vertex excludes itself)")
        with self._lock:
            tracer = self.tracer
            tr = None
            if tracer is not None and self._trace_sampled():
                tr = tracer.start("query", "query", graph=q.graph,
                                  vertex=int(q.vertex), k=int(q.k),
                                  requested=str(q.precision))
                if self._trace_rate < 1.0:
                    # lets an exporter backend re-weight sampled traces
                    tr.attrs["sample_rate"] = self._trace_rate
                sp = tr.span("resolve_precision", self.time_fn())
            pkey = self._resolve_precision(q)
            if tr is not None:
                sp.end(self.time_fn(), precision=pkey)
            self.telemetry.record_query_vertex(q.graph, int(q.vertex),
                                               k=q.k, pkey=pkey)
            fut = PPRFuture(q, self)
            if tr is not None:
                fut._trace = tr
                sp = tr.span("cache_probe", self.time_fn())
            hit = self.cache.get(self._cache_key(q, pkey))
            self.telemetry.record_cache(hit is not None)
            if tr is not None:
                sp.end(self.time_fn(), hit=hit is not None)
            if hit is not None:
                verts, scores = hit
                if not q.prefetch:
                    self.telemetry.record_query_latency(q.graph, 0.0)
                fut._resolve(Recommendation(q, verts.copy(), scores.copy(),
                                            source="cache", precision=pkey))
                if tr is not None:
                    tracer.finish(tr, outcome="resolved", source="cache",
                                  precision=pkey)
                    fut._trace = None
                if tl is not None:
                    tl.record(_SUBMIT, t_sub, _ns())
                return fut
            key = (q.graph, pkey, rg.mesh_key, rg.epoch)
            fut._wave_key = key
            now = self.time_fn()
            self.scheduler.submit(key, fut, deadline=q.deadline, now=now)
            self.telemetry.record_queue_depth(self.scheduler.queue_depth(),
                                              self.scheduler.oldest_wait_s(now))
            if tl is not None:
                tl.record(_SUBMIT, t_sub, _ns())
            return fut

    def poll(self, now: Optional[float] = None) -> int:
        """Launch every wave the admission policy considers ready; returns the
        number of waves launched.

        An *idle* poll (nothing launchable) with a prefetcher armed instead
        issues synthetic queries for predicted-hot uncached vertices and
        launches them immediately; their results fill the cache but resolve
        no caller-visible futures."""
        return self._launch_ready(now, allow_prefetch=True)

    def run_batch(self, queries: Sequence[PPRQuery]) -> List[Recommendation]:
        """Submit every query first (so full κ-waves form), flush, and gather
        the results in submission order."""
        futures = [self.submit(q) for q in queries]
        self.flush()
        return [f.result() for f in futures]

    def flush(self) -> int:
        """Launch everything pending regardless of occupancy; every pending
        future resolves.  Returns the number of waves launched."""
        with self._lock:
            popped = _admit(self.scheduler.drain)
        for wave in popped:
            self._run_wave(wave)
        return len(popped)

    def _drive(self, fut: PPRFuture) -> None:
        """Resolve one pending future synchronously: launch the ready waves,
        then flush the future's own wave if it is still queued."""
        self._launch_ready(None, allow_prefetch=False)
        if fut.done():
            return
        key = fut._wave_key
        if key is not None:
            with self._lock:
                popped = _admit(self.scheduler.flush_keys, {key})
            for wave in popped:
                self._run_wave(wave)

    def _launch_ready(self, now: Optional[float], allow_prefetch: bool) -> int:
        with self._lock:
            popped = _admit(self.scheduler.ready_waves, now=now)
        for wave in popped:
            self._run_wave(wave)
        waves = len(popped)
        if not waves and allow_prefetch and self.prefetcher is not None:
            # "idle" must mean idle: a deep queue with nothing launchable yet
            # (partial waves still inside their admission budgets) is live
            # traffic between waves, and synthetic warm-up compute would add
            # latency right where it hurts
            cfg = self.prefetcher.config
            suppress_at = (cfg.suppress_depth if cfg.suppress_depth is not None
                           else self.kappa)
            if self.scheduler.queue_depth() >= suppress_at:
                self.prefetcher.suppressed += 1
                self.telemetry.record_prefetch_suppressed()
            else:
                waves += self._prefetch_pump(now)
        return waves

    def _prefetch_pump(self, now: Optional[float]) -> int:
        """Issue + immediately launch synthetic queries for hot uncached
        vertices, under the cache key real traffic probes: each vertex's last
        real (k, resolved precision) when known — auto traffic records its
        post-resolution format, so that matches what the controller would
        resolve next — else the config's k at the controller's current rung.
        Returns the number of waves launched."""
        with self._lock:
            cfg = self.prefetcher.config
            now_s = self.time_fn() if now is None else now
            keys = set()
            issued = 0
            for name, rg in self._graphs.items():
                if issued >= cfg.max_per_pump:
                    break
                counts = self.telemetry.query_vertex_counts.get(name, {})
                last = self.telemetry.query_vertex_last.get(name, {})
                self.prefetcher.decay_demand(name, counts, now=now_s,
                                             last_seen=last)
                for v in self.prefetcher.candidates(name, counts,
                                                    cfg.max_per_pump - issued):
                    if not 0 <= v < rg.num_vertices:
                        continue              # stale demand from a dead topology
                    k_v, pkey = last.get(v, (cfg.k, None))
                    if pkey is None:
                        fmt = self.controller.resolve(name)
                        pkey = FLOAT_KEY if fmt is None else fmt.name
                    q = PPRQuery(name, int(v),
                                 k=min(k_v, rg.num_vertices - 1),
                                 precision=pkey, prefetch=True)
                    if self._cache_key(q, pkey) in self.cache:
                        continue              # membership probe: counter-free
                    key = (name, pkey, rg.mesh_key, rg.epoch)
                    fut = PPRFuture(q, self)
                    fut._wave_key = key
                    self.scheduler.submit(key, fut, now=now)
                    keys.add(key)
                    issued += 1
            if not issued:
                return 0
            self.prefetcher.issued += issued
            self.telemetry.record_prefetch(issued)
            popped = _admit(self.scheduler.flush_keys, keys)
        for wave in popped:
            self._run_wave(wave)
        return len(popped)

    def serve(self, queries: Sequence[PPRQuery]) -> List[Recommendation]:
        raise NotImplementedError("PPRService.serve() is deprecated in the "
                                  "reference and not ported: use run_batch()")

    def pump(self, now: Optional[float] = None) -> List[Recommendation]:
        raise NotImplementedError("PPRService.pump() is deprecated in the "
                                  "reference and not ported: use poll()")

    def drain(self) -> List[Recommendation]:
        raise NotImplementedError("PPRService.drain() is deprecated in the "
                                  "reference and not ported: use flush()")

    def telemetry_summary(self) -> Dict[str, float]:
        """Telemetry counters (cache_* = submit-path view) plus the LRU's own
        stats under lru_* — the two diverge once anything touches the cache
        outside submit() (e.g. the prefetcher) — the precision controller's
        ladder counters under autotune_*, and the warm-start store's and the
        prefetcher's under warm_* and prefetch_* when armed.
        ``register_stream_s``, where a registered graph built a dst stream
        (the fused family), sums those streams' build and upload seconds:
        registration state, which ``telemetry.reset()`` leaves alone."""
        s = self.telemetry.summary()
        built = [rg.register_timings for rg in tuple(self._graphs.values())
                 if "stream" in rg.register_timings]
        if built:
            s["register_stream_s"] = sum(t["stream"] + t.get("upload", 0.0)
                                         for t in built)
        s.update({f"lru_{k}": v for k, v in self.cache.stats().items()})
        s.update({f"autotune_{k}": v for k, v in self.controller.summary().items()})
        if self._warm is not None:
            s.update({f"warm_{k}": v for k, v in self._warm.stats().items()})
        if self.prefetcher is not None:
            s.update({f"prefetch_{k}": v
                      for k, v in self.prefetcher.stats().items()})
        return s

    # ------------------------------------------------------------------
    def _warm_seed(self, rg: RegisteredGraph, wave: Wave, pkey: str,
                   Vmat: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """``(P0, warm columns)``: the wave's start state, with each column
        whose personalization vertex has a stored converged column seeded from
        it instead of the one-hot restart.  A stored column counts only if it
        has the plan's vertex count (``Vmat``'s rows): a delta may have moved
        ``rg.num_vertices`` since the plan was bound."""
        num_vertices = int(Vmat.shape[0])
        cols, seeds = [], []
        for col, fut in enumerate(wave.items):
            s = self._warm.get(rg.name, int(fut.query.vertex), pkey)
            if s is not None and s.shape[0] == num_vertices:
                cols.append(col)
                seeds.append(s)
        if not seeds:
            return Vmat, 0
        host = np.stack(seeds, axis=1)
        if host.dtype == np.uint32:        # raw Qm.f bits → the int32 domain
            host = host.view(np.int32)
        P0 = Vmat.clone()
        P0[:, cols] = torch.as_tensor(host, device=Vmat.device)
        # pad columns duplicate column 0's personalization vertex; mirror its
        # seed too, or a cold pad column gates the wave's (global) early exit
        P0[:, len(wave.items):] = P0[:, :1]
        return P0, len(seeds)

    def _finish_rejected(self, fut: PPRFuture, code: str) -> None:
        """Close a rejected future's live trace (if tracing is armed)."""
        if self.tracer is not None and fut._trace is not None:
            self.tracer.finish(fut._trace, outcome="rejected", code=code)
            fut._trace = None

    # ------------------------------------------------------------------
    def _run_wave(self, wave: Wave) -> List[Recommendation]:
        tl = _trace.armed
        t_wave = _ns() if tl is not None else 0
        graph_name, pkey, mesh_key, epoch = wave.key
        rg = self._graphs[graph_name]
        fmt = None if pkey == FLOAT_KEY else normalize_precision(pkey)
        t0 = self.time_fn()

        # deadline-aware shed (before any compute is spent): strictly
        # past-deadline only, so a deadline-flushed wave still serves
        if any(f.query.deadline is not None for f in wave.items):
            live: List[PPRFuture] = []
            live_enq: List[float] = []
            for col, fut in enumerate(wave.items):
                q = fut.query
                enq = (wave.enqueued_at[col]
                       if col < len(wave.enqueued_at) else t0)
                if q.deadline is not None and t0 - enq > q.deadline:
                    self.telemetry.record_admission_wait(max(0.0, t0 - enq))
                    self.telemetry.record_deadline_shed(graph=q.graph)
                    fut._reject(QueryRejected(
                        f"query for vertex {q.vertex} on graph {q.graph!r} "
                        f"waited {t0 - enq:.4f}s in admission, past its "
                        f"{q.deadline:.4f}s deadline — dropped at wave "
                        f"launch rather than served late",
                        code="deadline-exceeded"))
                    self._finish_rejected(fut, "deadline-exceeded")
                else:
                    live.append(fut)
                    live_enq.append(enq)
            if not live:
                return []              # the whole wave expired in the queue
            wave = dataclasses.replace(wave, items=live, enqueued_at=live_enq)

        self._wave_counter += 1
        wave_id = self._wave_counter

        tracer = self.tracer
        iterate_info: Dict[str, object] = {}
        wtr = None
        # under head-sampling, a wave trace is kept iff any occupant was
        # sampled — an unsampled wave must not leak whole-traffic traces
        if tracer is not None and (
                self._trace_rate >= 1.0
                or any(f._trace is not None for f in wave.items)):
            wtr = tracer.start(
                "wave", "wave", t=t0, wave_id=wave_id, graph=graph_name,
                precision=pkey, mesh=mesh_key, full=wave.full,
                n_queries=len(wave.items),
                occupancy=len(wave.items) / self.kappa,
                member_traces=[f._trace.trace_id for f in wave.items
                               if f._trace is not None])
        for enq in wave.enqueued_at:
            self.telemetry.record_admission_wait(max(0.0, t0 - enq))

        # the graph's engine family decides how its waves iterate; arming
        # keeps late-bound engines in the delta device-refresh loop
        t_span = _ns() if tl is not None else 0
        engine = engine_for(rg.engine_family, fmt is not None)
        rg.arm(engine)
        plan = engine.plan(rg, fmt, alpha=self.alpha,
                           iterations=self.iterations,
                           convergence=self.convergence,
                           topk_tile=self.topk_tile,
                           trace_hook=iterate_info.update
                           if tracer is not None else None)

        queries = [fut.query for fut in wave.items]
        verts = [int(q.vertex) for q in queries]
        padded = verts + [verts[0]] * (self.kappa - len(verts))  # pads discarded
        pers = torch.as_tensor(np.asarray(padded, np.int32), device=rg.device)

        Vmat = plan.initial(pers)
        if tl is not None:
            tl.record(_PLAN, t_span, _ns(), wave_id)
        t_plan = self.time_fn()
        self.telemetry.record_stage("plan", t_plan - t0)
        P0, warm_cols = (self._warm_seed(rg, wave, pkey, Vmat)
                         if self._warm is not None else (Vmat, 0))
        t_warm = self.time_fn()
        self.telemetry.record_stage("warm_start", t_warm - t_plan)
        t_span = _ns() if tl is not None else 0
        # the plan's own step bound to Vmat: what lets a fused fixed-budget
        # iterate replay the wave as one captured graph
        P, iters_run = plan.iterate(functools.partial(plan.step, Vmat), P0)
        if tl is not None:
            tl.record(_ITERATE, t_span, _ns(), wave_id)
        if iters_run < self.iterations:
            self.telemetry.record_early_exit(self.iterations - iters_run)
        self.telemetry.record_wave_iterations(iters_run)
        warm_saved = 0
        if self._warm is not None:
            P_host = P.cpu().numpy()       # one copy of the state a wave
            if plan.fixed:
                P_host = P_host.view(np.uint32)
            for col, q in enumerate(queries):
                self._warm.put(graph_name, int(q.vertex), pkey,
                               P_host[:, col].copy())
            if warm_cols:
                base = self._cold_iters.get((graph_name, pkey))
                warm_saved = max(0, base - iters_run) if base is not None else 0
                self.telemetry.record_warm_start(warm_cols, warm_saved)
            else:
                self._cold_iters[(graph_name, pkey)] = iters_run
        t_iter = self.time_fn()
        self.telemetry.record_stage("iterate", t_iter - t_warm)

        k_max = max(q.k for q in queries)
        t_span = _ns() if tl is not None else 0
        idx, vals = plan.topk(P, k_max, pers)
        if tl is not None:
            t_copy = _ns()
            tl.record(_TOPK, t_span, t_copy, wave_id)
        idx = idx.cpu().numpy()                     # [κ, k_max]
        vals = vals.cpu().numpy()
        if tl is not None:
            tl.record(_DEVICE_WAIT, t_copy, _ns(), wave_id)
        scores = (vals.view(np.uint32).astype(np.float64) / plan.scale
                  if plan.fixed else vals.astype(np.float64))
        t_topk = self.time_fn()
        self.telemetry.record_stage("topk", t_topk - t_iter)
        latency = t_topk - t0

        recs = []
        t_span = _ns() if tl is not None else 0
        with self._lock:
            for col, fut in enumerate(wave.items):
                q = fut.query
                v_top = idx[col, : q.k].copy()
                s_top = scores[col, : q.k].copy()
                # the cache keeps its own copies
                self.cache.put(self._cache_key(q, pkey, epoch=epoch),
                               (v_top.copy(), s_top.copy()))
                recs.append(Recommendation(q, v_top, s_top, source="wave",
                                           wave_id=wave_id, latency_s=latency,
                                           precision=pkey))
            t_resolve = self.time_fn()
            self.telemetry.record_stage("resolve", t_resolve - t_topk)
            # per-occupant end-to-end latency (submit → resolution); synthetic
            # prefetch queries are cache warming, not traffic
            for col, fut in enumerate(wave.items):
                if not fut.query.prefetch:
                    enq = (wave.enqueued_at[col]
                           if col < len(wave.enqueued_at) else t0)
                    self.telemetry.record_query_latency(
                        graph_name, max(0.0, t_resolve - enq))
            self.telemetry.record_wave(len(wave.items), self.kappa, latency,
                                       pkey, mesh_key=mesh_key,
                                       engine=plan.engine, graph=graph_name)
        if tl is not None:
            tl.record(_RESOLVE, t_span, _ns(), wave_id)
        self._shadow_feedback(wave, rg, fmt, pkey, P)
        if wtr is not None:
            wtr.span("plan", t0).end(t_plan, engine=plan.engine)
            wtr.span("warm_start", t_plan).end(
                t_warm, warm_cols=warm_cols, iterations_saved=warm_saved)
            wtr.span("iterate", t_warm).end(t_iter, **iterate_info)
            wtr.span("topk", t_iter).end(t_topk, k_max=k_max)
            wtr.span("resolve", t_topk).end(t_resolve)
            tracer.finish(wtr, latency_s=latency, engine=plan.engine)
        # resolve futures last: a waiter must observe the wave's completed
        # accounting (counters, traces, cache fills, shadow feedback)
        t_span = _ns() if tl is not None else 0
        for col, fut in enumerate(wave.items):
            fut._resolve(recs[col])
            if tracer is not None and fut._trace is not None:
                tr = fut._trace
                enq = (wave.enqueued_at[col]
                       if col < len(wave.enqueued_at) else t0)
                tr.span("admission_wait", enq).end(t0)
                tr.span("wave_execute", t0, wave_id=wave_id,
                        engine=plan.engine,
                        **iterate_info).end(self.time_fn())
                tracer.finish(tr, outcome="resolved", source="wave",
                              precision=pkey,
                              wave_trace=wtr.trace_id if wtr else None)
                fut._trace = None
        if tl is not None:
            t_end = _ns()
            tl.record(_CALLBACKS, t_span, t_end, wave_id)
            tl.record(_WAVE, t_wave, t_end, wave_id)
        return recs

    # ------------------------------------------------------------------
    def _shadow_feedback(self, wave: Wave, rg: RegisteredGraph,
                         fmt: Optional[QFormat], pkey: str,
                         P: torch.Tensor) -> None:
        """Quality feedback for the wave's auto queries (sampled).

        Every auto query consumes exactly one sampling draw (in wave order),
        so a replayed query sequence under a seeded estimator makes identical
        shadow decisions regardless of how the ladder moved in between.
        Float32-served auto queries are perfect by definition: their sampled
        observations feed the ladder and telemetry as 1.0 without running a
        reference.

        The float32 reference runs through the graph's own float engine (on
        the "fused" family, the fused-iteration kernel; on a meshed graph it
        stays on the mesh, whose full layout is never uploaded) over only
        the sampled columns, for the full iteration budget with no early
        exit, so shadow cost scales with ``sample_fraction``.  Only the sampled
        columns of the served state and the reference are copied to the
        host, once a wave."""
        estimator = self.controller.estimator
        sampled = [(col, fut.query) for col, fut in enumerate(wave.items)
                   if fut.query.precision == AUTO_KEY
                   and estimator.should_sample()]
        if not sampled:
            return
        if fmt is None:
            with self._lock:   # controller state is shared with submit-time resolution
                for _, q in sampled:
                    self.controller.observe_quality(rg.name, FLOAT_KEY, 1.0,
                                                    target=q.quality_target)
                    self.telemetry.record_shadow(1.0)
            return
        pers_sub = torch.as_tensor(
            np.asarray([int(q.vertex) for _, q in sampled], np.int32),
            device=rg.device)
        try:
            float_engine = engine_for(rg.engine_family, False)
        except KeyError:
            return      # fixed-only family: no float datapath for a reference
        P_ref = self._float_reference(rg, float_engine, pers_sub)
        ref, approx = self._sampled_to_host(P_ref, P, [col for col, _ in sampled], fmt)
        with self._lock:   # the reference compute above ran unlocked
            for j, (_, q) in enumerate(sampled):
                ref_col = ref[:, j]
                score = self.controller.observe_shadow(
                    rg.name, pkey, approx[:, j], ref_col,
                    target=q.quality_target, ref_order=ranking(ref_col))
                self.telemetry.record_shadow(score)

    def _float_reference(self, rg: RegisteredGraph, float_engine,
                         pers: torch.Tensor) -> torch.Tensor:
        """The shadow reference: float32 PPR of ``pers`` through
        ``float_engine``, the full iteration budget with no early exit."""
        rg.arm(float_engine)
        plan = float_engine.plan(rg, None, alpha=self.alpha,
                                 iterations=self.iterations)
        V = plan.initial(pers)
        P = V
        for _ in range(self.iterations):
            P = plan.step(V, P)
        return P

    @staticmethod
    def _sampled_to_host(P_ref: torch.Tensor, P: torch.Tensor, cols: List[int],
                         fmt: QFormat) -> Tuple[np.ndarray, np.ndarray]:
        """float64 host copies of the reference and of the served state's
        sampled ``cols``, the latter in value units."""
        ref = P_ref.cpu().numpy().astype(np.float64)
        # raw Qm.f bits: the int32 tensor holds the reference's uint32 values
        approx = P[:, cols].cpu().numpy().view(np.uint32).astype(np.float64) / fmt.scale
        return ref, approx
