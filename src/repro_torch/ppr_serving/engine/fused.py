"""Fused engines: one kernel call per eq. (1) iteration.

Counterpart of ``repro.ppr_serving.engine.pallas``: family ``"fused"`` (the
reference's ``"pallas"``), keys ``fused_float``/``fused_fixed``.  The family
serves the same waves as "single" but through
``repro_torch.kernels.fused_ppr.fused_ppr_iteration``: dangling-mass fold,
SpMV, the eq. (1) combine and the (L1, ∞, Σd²) residual over the pad-free
dst stream (``kernels/dst_stream.py``) — on CUDA the hand-written kernels,
on the CPU their plain versions.  The fixed member is bit-identical (raw
bits) to ``FixedEngine``; the float member matches ``FloatEngine`` to f32
accumulation-order noise.

State layout (on ``FusedRegisteredGraph``): the packetized ``FusedLayout``
on the host, the dst stream built from it, and on the device only the
stream: its topology (``row_ptr``, ``col``, slice schedule), the dangling
list, the float values and one raw value array per prepared Q format.
``on_delta`` re-packetizes only the dst blocks an edge delta touched
(``changed_dst // v_tile``) — per-block rebuilds are deterministic, so the
incremental layout is array-equal to a fresh registration of the merged
graph — behind a staleness latch (both family members are armed and each
gets the callback), then builds a new dst stream from the refreshed layout
and uploads it in place of the old one, whose device tensors it releases.

The early-exit driver reuses the kernel's residual output instead of
``ConvergenceMonitor``'s separate device reductions, with identical exit
decisions: a zero ∞-residual *is* the monitor's exact integer equality (the
minimum nonzero raw diff, 1.0, is exactly representable in f32), period-2
cycles are still caught by comparing against S_{t-2}, and the parity of the
remaining budget picks the bit-identical return state.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.autotune.convergence import ConvergencePolicy, states_equal
from repro_torch.core.coo import COOGraph
from repro_torch.core.fixed_point import QFormat
from repro_torch.core.ppr import personalization_matrix, personalization_matrix_fixed
from repro_torch.kernels.dst_stream import DstStream, build_dst_stream
from repro_torch.kernels.fused_ppr import build_fused_layout, fused_ppr_iteration
from repro_torch.obs import trace as _trace
from repro_torch.ppr_serving.engine.base import WaveEngine, WavePlan, register_engine
from repro_torch.ppr_serving.graphs import RegisteredGraph

__all__ = ["FusedRegisteredGraph", "FusedFloatEngine", "FusedFixedEngine"]

DEFAULT_V_TILE = 512

_STEP = _trace.span_id("ppr.step")


class FusedRegisteredGraph(RegisteredGraph):
    """Registered graph carrying the fused layouts.

    Defers the full-layout upload (fused waves never read it) and owns the
    fused caches: the host ``FusedLayout``, the dst stream built from it, and
    the stream's device uploads (topology once, values once per format)."""

    engine_family = "fused"

    _defer_full_upload = True

    def __init__(self, name: str, g: COOGraph, packet: int = 256,
                 v_tile: int = DEFAULT_V_TILE, device="cuda"):
        self.v_tile = int(v_tile)
        self._fused_layout = None
        self._fused_stream: Optional[DstStream] = None
        self._dang_idx = None
        self._fused_stale = False
        self._fused_full_rebuild = False
        self._fused_dirty: set = set()
        #: dst blocks the last refresh re-packetized; None for a full rebuild
        self.last_refresh_blocks: Optional[int] = None
        super().__init__(name, g, packet=packet, device=device)

    # ---- fused caches ------------------------------------------------------
    def fused_layout(self):
        if self._fused_layout is None:
            self._fused_layout = build_fused_layout(self.source, self.v_tile,
                                                    self.packet)
        return self._fused_layout

    def fused_stream(self) -> DstStream:
        """The pad-free dst stream of the fused layout (host)."""
        if self._fused_stream is None:
            self._fused_stream = build_dst_stream(self.fused_layout())
        return self._fused_stream

    def fused_topology(self):
        """The stream's ``StreamTopology`` on the graph's device (``row_ptr``,
        ``col`` and the slice schedule, uploaded once)."""
        return self.fused_stream().topology(self.device)

    def fused_dangling(self):
        """The int32 list of dangling vertices on the graph's device."""
        if self._dang_idx is None:
            self._dang_idx = torch.as_tensor(
                np.nonzero(self.graph.dangling)[0].astype(np.int32), device=self.device)
        return self._dang_idx

    def fused_values(self, fmt: Optional[QFormat] = None):
        """[E] value operand — f32 (fmt=None) or raw int32 bits."""
        return self.fused_stream().values(self.device, fmt)

    # ---- delta ingestion ---------------------------------------------------
    def apply_delta(self, delta):
        """Host merge plus dirty-dst-block tracking for the fused layout.

        ``changed_dst`` covers every destination whose incident edge set or
        edge values moved (including removed edges' old rows); vertex growth
        that changes the block count forces a full re-packetization."""
        info = super().apply_delta(delta)
        if self._fused_layout is not None:
            n_blk = max(1, -(-self.num_vertices // self.v_tile))
            if n_blk != self._fused_layout.n_blk:
                self._fused_full_rebuild = True
            else:
                self._fused_dirty.update(
                    int(b) for b in np.unique(info.changed_dst // self.v_tile))
            self._fused_stale = True
        else:
            self._dang_idx = None       # nothing built from the stream yet
        return info

    def refresh_fused(self) -> None:
        """Re-packetize the dirty dst blocks, rebuild the dst stream from the
        refreshed layout and upload what the old stream had uploaded (its
        topology, the dangling list, the values of every format), releasing
        the old uploads.  Idempotent across the family's two armed engines
        (staleness latch)."""
        if not self._fused_stale:
            return
        self._fused_stale = False
        old, dirty = self._fused_layout, self._fused_dirty
        self._fused_dirty = set()
        full = self._fused_full_rebuild or old is None
        self._fused_full_rebuild = False
        uploaded = self._fused_stream.release() if self._fused_stream is not None else []
        had_dangling = self._dang_idx is not None
        self._fused_stream = self._dang_idx = None
        t0 = time.perf_counter()
        self._fused_layout = build_fused_layout(self.source, self.v_tile, self.packet,
                                                reuse=None if full else old,
                                                dirty=None if full else dirty)
        t1 = time.perf_counter()
        self.fused_stream()
        t2 = time.perf_counter()
        for key in uploaded:
            if key[0] == "topology":
                self.fused_topology()
            else:
                self.fused_values(key[2])
        if had_dangling:
            self.fused_dangling()
        self.delta_timings.update(repacketize=t1 - t0, stream=t2 - t1,
                                  upload=time.perf_counter() - t2)
        self.last_refresh_blocks = None if full else len(dirty)


# ---------------------------------------------------------------------------
# wave plumbing
# ---------------------------------------------------------------------------
def _bind_fused_step(rg: FusedRegisteredGraph, fmt: Optional[QFormat],
                     alpha: float, cell: dict):
    """Step closure over the graph's current fused device state.  Each call
    parks the kernel's [3, K] residual in ``cell`` for the iterate driver."""
    topo, dang_idx = rg.fused_topology(), rg.fused_dangling()
    val = rg.fused_values(fmt)

    def step(Vmat, P):
        tl = _trace.armed
        t0 = time.perf_counter_ns() if tl is not None else 0
        P_next, res = fused_ppr_iteration(topo, val, dang_idx, Vmat, P, alpha=alpha,
                                          fmt=fmt)
        if tl is not None:
            tl.record(_STEP, t0, time.perf_counter_ns())
        cell["res"] = res
        return P_next

    return step


def _residual_delta(res, scale: Optional[int]) -> float:
    """max-over-columns L2 state change in value units (``wave_delta`` on the
    kernel's Σd² row — max ∘ sqrt = sqrt ∘ max)."""
    d = float(torch.sqrt(res[2].max()))
    return d / scale if scale else d


def _make_fused_iterate(engine: WaveEngine, iterations: int,
                        convergence: Optional[ConvergencePolicy],
                        fixed: bool, scale: Optional[int], cell: dict,
                        trace_hook=None):
    """The ``run_until_converged`` contract driven off the kernel's fused
    residual: same check cadence, same exit conditions, same parity-correct
    return states as ``ConvergenceMonitor`` — without its per-check
    full-array device comparisons (the ∞-residual is already on device).

    With a ``trace_hook`` the residual of every check is kept, checks before
    ``min_iterations`` included (one host read of the kernel's Σd² row
    each), and the hook gets the same dict on every exit; a hookless wave
    checks only from ``min_iterations`` on, where a check can exit."""
    if convergence is None:
        return engine._make_iterate(iterations, None, fixed, scale,
                                    trace_hook=trace_hook)
    pol = convergence
    track = trace_hook is not None

    def finish(P, t, deltas):
        if track:
            trace_hook({
                "iterations_run": t, "budget": iterations,
                "early_exit": t < iterations,
                "residual": float(deltas[-1]) if deltas else None,
            })
        return P, t

    def iterate(step, P0):
        deltas = []
        P, prev2 = P0, None
        for t in range(1, iterations + 1):
            P_next = step(P)
            res = cell["res"]
            checking = (t % pol.check_every == 0
                        and (track or t >= pol.min_iterations))
            prev2, prev2_at_check = (P, prev2) if fixed else (None, None)
            if checking and fixed:
                # zero ∞-residual ⇔ exact integer state equality: raw diffs
                # are whole numbers, the smallest nonzero one (1.0) is
                # exactly representable in f32 and a max never rounds a
                # nonzero operand to zero.
                strict = bool(res[1].max() == 0.0)
                if track:
                    deltas.append(0.0 if strict else _residual_delta(res, scale))
                if t >= pol.min_iterations:
                    if strict:
                        return finish(P_next, t, deltas)
                    if prev2_at_check is not None and states_equal(
                            P_next, prev2_at_check):
                        # period-2 absorbing cycle: parity of the remaining
                        # budget picks the bit-identical state
                        if (iterations - t) % 2 != 0:
                            return finish(P, t, deltas)
                        return finish(P_next, t, deltas)
            elif checking:
                deltas.append(_residual_delta(res, scale))
                if t >= pol.min_iterations and deltas[-1] < pol.epsilon:
                    return finish(P_next, t, deltas)
            P = P_next
        return finish(P, iterations, deltas)

    return iterate


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
@register_engine
class FusedFloatEngine(WaveEngine):
    """float32 fused iterations over the dst stream."""

    key = "fused_float"
    family = "fused"
    fixed = False

    def make_graph(self, name: str, g, packet: int = 256, mesh=None,
                   mesh_axis: Optional[str] = None, device="cuda"):
        return FusedRegisteredGraph(name, g, packet=packet, device=device)

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        rg.fused_topology()
        rg.fused_dangling()
        rg.fused_values(None)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None, trace_hook=None) -> WavePlan:
        self.prepare(rg)
        num_vertices = rg.num_vertices
        cell = {"res": None}
        return WavePlan(
            engine=self.key, fixed=False, scale=None,
            initial=lambda pers: personalization_matrix(num_vertices, pers),
            step=_bind_fused_step(rg, None, alpha, cell),
            iterate=_make_fused_iterate(self, iterations, convergence, False,
                                        None, cell, trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()
        rg.refresh_fused()


@register_engine
class FusedFixedEngine(WaveEngine):
    """Bit-exact reduced-precision fused iterations (raw bits)."""

    key = "fused_fixed"
    family = "fused"
    fixed = True

    def make_graph(self, name: str, g, packet: int = 256, mesh=None,
                   mesh_axis: Optional[str] = None, device="cuda"):
        return FusedRegisteredGraph(name, g, packet=packet, device=device)

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        if fmt is None:
            raise ValueError(f"{self.key!r} engine needs a concrete Q format")
        rg.fused_topology()
        rg.fused_dangling()
        rg.fused_values(fmt)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None, trace_hook=None) -> WavePlan:
        if fmt is None:
            raise ValueError(f"{self.key!r} engine needs a concrete Q format")
        self.prepare(rg, fmt)
        num_vertices = rg.num_vertices
        cell = {"res": None}
        return WavePlan(
            engine=self.key, fixed=True, scale=fmt.scale,
            initial=lambda pers: personalization_matrix_fixed(
                num_vertices, pers, fmt),
            step=_bind_fused_step(rg, fmt, alpha, cell),
            iterate=_make_fused_iterate(self, iterations, convergence, True,
                                        fmt.scale, cell, trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()
        rg.refresh_fused()
