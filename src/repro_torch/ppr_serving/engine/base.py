"""`WaveEngine` protocol + `WavePlan` + the engine registry.

Counterpart of ``repro.ppr_serving.engine.base``.  The port registers the
"single", "fused" and "sharded" families.

An engine is the pluggable datapath behind the serving API: it owns how a
registered graph's device state is prepared (quantization, partitioning,
uploads), how one eq. (1) iteration steps, how a wave's iterations are driven
(fixed budget or early-exit), and how the rank matrix is reduced to top-K.
The service knows none of that — it asks the graph's engine for a
``WavePlan`` and runs it.

Engines are stateless singletons; all per-graph state (host arrays, device
uploads, shard buckets) lives on the ``RegisteredGraph`` they operate on, so
one engine instance serves every graph and the registry can hand out shared
instances.

Registry layout: every concrete engine registers under its own ``key``
("float", "fixed", "fused_float", "fused_fixed", "sharded_float",
"sharded_fixed") and into a *family* ("single", "fused", "sharded") with one
float and one fixed member — a graph is
registered onto a family (``register_graph(..., engine="fused")``) and each
wave resolves to the family's member for its precision, so float and fixed
traffic on one graph share host state but run their own datapaths.  New
backends plug in as new families without touching the service.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

from repro_torch.autotune.convergence import ConvergencePolicy, run_until_converged
from repro_torch.core.fixed_point import QFormat
from repro_torch.ppr_serving.topk import topk_dense, topk_streaming

__all__ = [
    "WavePlan", "WaveEngine",
    "register_engine", "get_engine", "engine_for", "family_members",
    "engine_names", "engine_families",
]


@dataclasses.dataclass
class WavePlan:
    """Everything one wave needs, bound to device state by an engine.

    ``engine``   the concrete engine key (telemetry label).
    ``fixed``    raw uint32 domain (True) or float32 (False).
    ``scale``    ``fmt.scale`` for fixed plans (dequantization divisor), else None.
    ``initial``  pers [κ] int32 → P0 [V, κ] (one-hot personalization matrix).
    ``step``     (Vmat, P) → P_next, one eq. (1) iteration on the engine's
                 device arrays.
    ``iterate``  (step_closure, P0) → (P_final, iterations_run); drives the
                 wave's iterations, early-exiting when the engine was planned
                 with a convergence policy.
    ``topk``     (P, k_max, exclude) → (idx [κ, k], vals [κ, k]) ranked with
                 the query vertex excluded.
    """
    engine: str
    fixed: bool
    scale: Optional[int]
    initial: Callable[[Any], Any]
    step: Callable[[Any, Any], Any]
    iterate: Callable[[Callable[[Any], Any], Any], Tuple[Any, int]]
    topk: Callable[[Any, int, Optional[Any]], Tuple[Any, Any]]


class WaveEngine(abc.ABC):
    """One datapath backend: prepare device state and plan waves.

    Subclasses set ``key`` (registry name), ``family`` (engine pair a graph
    registers onto) and ``fixed`` (which precision domain the engine serves),
    and implement ``prepare``/``plan`` (and ``on_delta`` where they hold
    device state a delta invalidates).
    """

    key: ClassVar[str]
    family: ClassVar[str]
    fixed: ClassVar[bool]
    #: family needs a ``launch.mesh.Mesh`` at registration
    needs_mesh: ClassVar[bool] = False

    def make_graph(self, name: str, g, packet: int = 256, mesh=None,
                   mesh_axis: Optional[str] = None, device="cuda"):
        """Construct the graph-state holder this engine family serves, with
        its device uploads on ``device`` (a meshed graph's on the mesh).

        The service calls the family's first member at registration, so a
        new family can carry its own ``RegisteredGraph`` subclass without a
        ``service.py`` edit."""
        from repro_torch.ppr_serving.graphs import (RegisteredGraph,
                                                    ShardedRegisteredGraph)
        if self.needs_mesh:
            return ShardedRegisteredGraph(name, g, mesh, axis=mesh_axis,
                                          packet=packet, device=device)
        return RegisteredGraph(name, g, packet=packet, device=device)

    @abc.abstractmethod
    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        """Materialize the device state ``plan`` will bind (uploads,
        quantization, partitioning).  Called at registration for every
        pre-registered format and lazily from ``plan`` for late formats."""

    @abc.abstractmethod
    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int,
             convergence: Optional[ConvergencePolicy] = None,
             topk_tile: Optional[int] = None,
             trace_hook: Optional[Callable[[Dict[str, Any]], None]] = None
             ) -> WavePlan:
        """Bind a ``WavePlan`` to ``rg``'s current device state.

        ``trace_hook``, when given, receives one dict per ``iterate`` call
        with the convergence internals a trace wants (``iterations_run``,
        ``budget``, ``early_exit``, and the last checked ``residual`` when an
        early-exit policy is active).  Tracking residuals costs host syncs,
        so the hook — not the service — decides whether the monitor runs
        with ``track_deltas``; a hookless plan pays nothing."""

    def on_delta(self, rg, info) -> None:
        """Refresh the engine's device state after a host-side edge-delta
        merge (``rg.apply_delta``).  Must be idempotent — both members of a
        family are armed on most graphs and each gets the callback.  A no-op
        here, for engines that hold no device state of their own."""

    # ------------------------------------------------------------------
    # shared drivers
    def _make_iterate(self, iterations: int,
                      convergence: Optional[ConvergencePolicy],
                      fixed: bool, scale: Optional[int],
                      trace_hook=None):
        """Wave iteration driver: fixed budget, or early-exit under a policy.

        With a ``trace_hook``, convergence runs ``track_deltas=True`` (the
        per-iteration residuals cost host syncs — only a tracing wave pays
        them) and the hook receives the iterate's convergence internals."""
        if convergence is None:
            def iterate(step, P0):
                P = P0
                for _ in range(iterations):
                    P = step(P)
                if trace_hook is not None:
                    trace_hook({"iterations_run": iterations,
                                "budget": iterations, "early_exit": False})
                return P, iterations
            return iterate

        def iterate(step, P0):
            track = trace_hook is not None
            P, iters_run, deltas = run_until_converged(
                step, P0, iterations, convergence, fixed=fixed,
                scale=scale, track_deltas=track)  # hookless: skip the syncs
            if track:
                trace_hook({
                    "iterations_run": iters_run, "budget": iterations,
                    "early_exit": iters_run < iterations,
                    "residual": float(deltas[-1]) if deltas else None,
                })
            return P, iters_run
        return iterate

    def _make_topk(self, topk_tile: Optional[int]):
        if topk_tile is None:
            return lambda P, k, exclude: topk_dense(P, k, exclude=exclude)
        return lambda P, k, exclude: topk_streaming(P, k, v_tile=topk_tile,
                                                    exclude=exclude)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} key={self.key!r} family={self.family!r}>"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_ENGINES: Dict[str, WaveEngine] = {}
_FAMILIES: Dict[str, Dict[bool, str]] = {}


def register_engine(cls):
    """Class decorator: instantiate and index the engine by key and family.

    Re-registering a key replaces the previous engine (deliberate: downstream
    code can swap a backend in tests or experiments)."""
    inst = cls()
    _ENGINES[cls.key] = inst
    _FAMILIES.setdefault(cls.family, {})[cls.fixed] = cls.key
    return cls


def get_engine(key: str) -> WaveEngine:
    """The concrete engine registered under ``key``."""
    if key not in _ENGINES:
        raise KeyError(f"no engine {key!r} registered "
                       f"(have {sorted(_ENGINES)})")
    return _ENGINES[key]


def engine_for(family: str, fixed: bool) -> WaveEngine:
    """The family member serving ``fixed`` (True) or float (False) waves."""
    if family not in _FAMILIES:
        raise KeyError(f"no engine family {family!r} registered "
                       f"(have {sorted(_FAMILIES)})")
    members = _FAMILIES[family]
    if fixed not in members:
        raise KeyError(f"engine family {family!r} has no "
                       f"{'fixed' if fixed else 'float'} member")
    return _ENGINES[members[fixed]]


def family_members(family: str) -> Tuple[WaveEngine, ...]:
    """The registered members of ``family``, float member first when present.

    Fixed-only families are legal (e.g. a fixed-point kernel backend
    with no float counterpart): the service resolves family-level metadata
    (``make_graph``) through any member and requires a float
    member only when float traffic or a shadow reference actually needs it."""
    if family not in _FAMILIES:
        raise KeyError(f"no engine family {family!r} registered "
                       f"(have {sorted(_FAMILIES)})")
    members = _FAMILIES[family]
    return tuple(_ENGINES[members[fixed]] for fixed in sorted(members))


def engine_names() -> Tuple[str, ...]:
    """All registered concrete engine keys, sorted."""
    return tuple(sorted(_ENGINES))


def engine_families() -> Tuple[str, ...]:
    """All registered engine families (what ``register_graph(engine=...)``
    selects by name), sorted."""
    return tuple(sorted(_FAMILIES))
