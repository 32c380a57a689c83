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
list, the float values and one raw value array per prepared Q format.  The
delta refresh (``refresh_fused``, which rebuilds the stream) comes with the
delta slice.

The early-exit driver reuses the kernel's residual output instead of
``ConvergenceMonitor``'s separate device reductions, with identical exit
decisions: a zero ∞-residual *is* the monitor's exact integer equality (the
minimum nonzero raw diff, 1.0, is exactly representable in f32), period-2
cycles are still caught by comparing against S_{t-2}, and the parity of the
remaining budget picks the bit-identical return state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.autotune.convergence import ConvergencePolicy, states_equal
from repro_torch.core.coo import COOGraph
from repro_torch.core.fixed_point import QFormat
from repro_torch.core.ppr import personalization_matrix, personalization_matrix_fixed
from repro_torch.kernels.dst_stream import DstStream, build_dst_stream
from repro_torch.kernels.fused_ppr import build_fused_layout, fused_ppr_iteration
from repro_torch.ppr_serving.engine.base import WaveEngine, WavePlan, register_engine
from repro_torch.ppr_serving.graphs import RegisteredGraph

__all__ = ["FusedRegisteredGraph", "FusedFloatEngine", "FusedFixedEngine"]

DEFAULT_V_TILE = 512


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
        P_next, res = fused_ppr_iteration(topo, val, dang_idx, Vmat, P, alpha=alpha,
                                          fmt=fmt)
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
                        fixed: bool, scale: Optional[int], cell: dict):
    """The ``run_until_converged`` contract driven off the kernel's fused
    residual: same check cadence, same exit conditions, same parity-correct
    return states as ``ConvergenceMonitor`` — without its per-check
    full-array device comparisons (the ∞-residual is already on device)."""
    if convergence is None:
        return engine._make_iterate(iterations, None, fixed, scale)
    pol = convergence

    def iterate(step, P0):
        P, prev2 = P0, None
        for t in range(1, iterations + 1):
            P_next = step(P)
            res = cell["res"]
            checking = (t % pol.check_every == 0
                        and t >= pol.min_iterations)
            prev2, prev2_at_check = (P, prev2) if fixed else (None, None)
            if checking and fixed:
                # zero ∞-residual ⇔ exact integer state equality: raw diffs
                # are whole numbers, the smallest nonzero one (1.0) is
                # exactly representable in f32 and a max never rounds a
                # nonzero operand to zero.
                if bool(res[1].max() == 0.0):
                    return P_next, t
                if prev2_at_check is not None and states_equal(
                        P_next, prev2_at_check):
                    # period-2 absorbing cycle: parity of the remaining
                    # budget picks the bit-identical state
                    if (iterations - t) % 2 != 0:
                        return P, t
                    return P_next, t
            elif checking and _residual_delta(res, scale) < pol.epsilon:
                return P_next, t
            P = P_next
        return P, iterations

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

    def make_graph(self, name: str, g, packet: int = 256, device="cuda"):
        return FusedRegisteredGraph(name, g, packet=packet, device=device)

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        rg.fused_topology()
        rg.fused_dangling()
        rg.fused_values(None)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None) -> WavePlan:
        self.prepare(rg)
        num_vertices = rg.num_vertices
        cell = {"res": None}
        return WavePlan(
            engine=self.key, fixed=False, scale=None,
            initial=lambda pers: personalization_matrix(num_vertices, pers),
            step=_bind_fused_step(rg, None, alpha, cell),
            iterate=_make_fused_iterate(self, iterations, convergence, False,
                                        None, cell),
            topk=self._make_topk(topk_tile))


@register_engine
class FusedFixedEngine(WaveEngine):
    """Bit-exact reduced-precision fused iterations (raw bits)."""

    key = "fused_fixed"
    family = "fused"
    fixed = True

    def make_graph(self, name: str, g, packet: int = 256, device="cuda"):
        return FusedRegisteredGraph(name, g, packet=packet, device=device)

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        if fmt is None:
            raise ValueError(f"{self.key!r} engine needs a concrete Q format")
        rg.fused_topology()
        rg.fused_dangling()
        rg.fused_values(fmt)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None) -> WavePlan:
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
                                        fmt.scale, cell),
            topk=self._make_topk(topk_tile))
