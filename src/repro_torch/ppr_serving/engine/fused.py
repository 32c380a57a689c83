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

State layout (on ``FusedRegisteredGraph``): on the host the dst stream,
built straight from the graph's (dst, src)-sorted COO arrays, and on the
device only the stream: its topology (``row_ptr``, ``col``, slice schedule),
the dangling list, the float values and one raw value array per prepared Q
format.  The stream is array-equal to the one of the packet-padded
``FusedLayout`` (a stable sort by dst keeps the COO's src order inside a
row), which no served path builds: at 2^20 vertices and the default
``v_tile`` that layout would hold ~1e9 slots.  ``on_delta``, behind a
staleness latch (both family members are armed and each gets the callback),
builds a new dst stream from the merged COO arrays and uploads it in place
of the old one, whose device tensors it releases.  A ``FusedLayout`` built
on demand (``fused_layout()``, for the parity tests) is kept up to date too:
only the dst blocks a delta touched (``changed_dst // v_tile``) are
re-packetized, and per-block rebuilds are deterministic, so the incremental
layout is array-equal to a fresh build of the merged graph.

A fixed-budget wave on CUDA replays its ``iterations`` steps as one captured
CUDA graph (``FusedChain``): the host's work per wave drops from ``iterations``
wrapper calls (allocations, operand checks, a 36-argument ctypes launch each)
to a copy of ``Vmat`` into the chain, one graph launch and a clone of its
output, while the device runs the same kernels with the same arguments in the
same order, so answers are unchanged bit for bit.  It engages when the iterate is handed its own plan's step bound
to one ``Vmat`` (``functools.partial(plan.step, Vmat)``), the tensors are on
CUDA and no early-exit policy is set; anything else runs the eager loop.  The
first wave of a (format, κ, α, budget, device, cold/warm) key runs eagerly on
the capture stream and is captured after; a refresh drops every chain.

The early-exit driver reuses the kernel's residual output instead of
``ConvergenceMonitor``'s separate device reductions, with identical exit
decisions: a zero ∞-residual *is* the monitor's exact integer equality (the
minimum nonzero raw diff, 1.0, is exactly representable in f32), period-2
cycles are still caught by comparing against S_{t-2}, and the parity of the
remaining budget picks the bit-identical return state.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, Optional, Tuple

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
_REPLAY = _trace.span_id("ppr.wave.replay")
_STREAM = _trace.span_id("ppr.graph.stream")


class FusedRegisteredGraph(RegisteredGraph):
    """Registered graph carrying the fused family's state.

    Defers the full-layout upload (fused waves never read it) and owns the
    fused caches: the dst stream of the COO arrays (host), its device
    uploads (topology once, values once per format), and the padded
    ``FusedLayout`` only once a caller asks for it."""

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
        #: dst blocks the last refresh re-packetized (0 with no layout built);
        #: None for a full rebuild
        self.last_refresh_blocks: Optional[int] = None
        #: captured fixed-budget waves by (format, κ, α, budget, device, warm)
        self.fused_chains: Dict[tuple, FusedChain] = {}
        self._chain_pool = None         # one memory pool for all the chains
        super().__init__(name, g, packet=packet, device=device)

    # ---- fused caches ------------------------------------------------------
    def fused_layout(self):
        """The packet-padded ``FusedLayout`` (host), built on the first call:
        the parity tests' view of the stream, which no served path reads.
        Once built, deltas re-packetize its dirty blocks."""
        if self._fused_layout is None:
            self._fused_layout = build_fused_layout(self.source, self.v_tile,
                                                    self.packet)
        return self._fused_layout

    def fused_stream(self) -> DstStream:
        """The pad-free dst stream of the graph's COO arrays (host),
        array-equal to ``build_dst_stream(self.fused_layout())``.  Before any
        delta, the build's seconds go to ``register_timings["stream"]``."""
        if self._fused_stream is None:
            g = self.source
            t0 = time.perf_counter_ns()
            self._fused_stream = build_dst_stream((g.x, g.y, g.val, g.num_vertices))
            t1 = time.perf_counter_ns()
            tl = _trace.armed
            if tl is not None:
                tl.record(_STREAM, t0, t1)
            if self.epoch == 0:
                self.register_timings["stream"] = (t1 - t0) / 1e9
        return self._fused_stream

    def _note_uploads(self, stream: DstStream) -> None:
        if self.epoch == 0:
            self.register_timings["upload"] = stream.upload_s

    def fused_topology(self):
        """The stream's ``StreamTopology`` on the graph's device (``row_ptr``,
        ``col`` and the slice schedule, uploaded once)."""
        stream = self.fused_stream()
        topo = stream.topology(self.device)
        self._note_uploads(stream)
        return topo

    def fused_dangling(self):
        """The int32 list of dangling vertices on the graph's device."""
        if self._dang_idx is None:
            self._dang_idx = torch.as_tensor(
                np.nonzero(self.graph.dangling)[0].astype(np.int32), device=self.device)
        return self._dang_idx

    def fused_values(self, fmt: Optional[QFormat] = None):
        """[E] value operand — f32 (fmt=None) or raw int32 bits."""
        stream = self.fused_stream()
        val = stream.values(self.device, fmt)
        self._note_uploads(stream)
        return val

    # ---- delta ingestion ---------------------------------------------------
    def apply_delta(self, delta):
        """Host merge, plus dirty-dst-block tracking where a fused layout was
        built.

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
        if self._fused_layout is not None or self._fused_stream is not None:
            self._fused_stale = True
        else:
            self._dang_idx = None       # nothing built from the stream yet
        return info

    def refresh_fused(self) -> None:
        """Rebuild the dst stream from the merged COO arrays and upload what
        the old stream had uploaded (its topology, the dangling list, the
        values of every format), releasing the old uploads; re-packetize the
        dirty dst blocks of the fused layout where one was built.  Idempotent
        across the family's two armed engines (staleness latch)."""
        if not self._fused_stale:
            return
        self._fused_stale = False
        old, dirty = self._fused_layout, self._fused_dirty
        self._fused_dirty = set()
        full = self._fused_full_rebuild
        self._fused_full_rebuild = False
        if self.fused_chains:
            # no replay may still run over what the release frees
            torch.cuda.synchronize(self.device)
            self.fused_chains.clear()
            self._chain_pool = None
        uploaded = self._fused_stream.release() if self._fused_stream is not None else []
        had_dangling = self._dang_idx is not None
        self._fused_stream = self._dang_idx = None
        t0 = time.perf_counter()
        if old is not None:
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
class _FusedStep:
    """(Vmat, P) → P_next over the graph's fused device state as bound at
    plan time.  Each call parks the kernel's [3, K] residual in ``cell`` for
    the iterate driver.  A class, not a closure, so that the fixed-budget
    iterate can tell its own plan's step, and the operands it binds, from any
    other callable."""

    def __init__(self, rg: FusedRegisteredGraph, fmt: Optional[QFormat],
                 alpha: float, cell: dict):
        self.rg, self.fmt, self.alpha, self.cell = rg, fmt, alpha, cell
        self.topo, self.dang_idx = rg.fused_topology(), rg.fused_dangling()
        self.val = rg.fused_values(fmt)

    def operands(self):
        return self.topo, self.val, self.dang_idx

    def __call__(self, Vmat, P):
        tl = _trace.armed
        t0 = time.perf_counter_ns() if tl is not None else 0
        P_next, res = fused_ppr_iteration(self.topo, self.val, self.dang_idx, Vmat, P,
                                          alpha=self.alpha, fmt=self.fmt)
        if tl is not None:
            tl.record(_STEP, t0, time.perf_counter_ns())
        self.cell["res"] = res
        return P_next


# ---------------------------------------------------------------------------
# fixed-budget waves replayed as one CUDA graph
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FusedChain:
    """One captured fixed-budget wave: ``iterations`` fused steps over the
    static ``vmat`` from the static ``p0`` (``vmat`` itself on a cold chain),
    ending in ``out``, captured over ``operands`` (topology, values,
    dangling list)."""
    graph: "torch.cuda.CUDAGraph"
    vmat: torch.Tensor
    p0: Optional[torch.Tensor]
    out: torch.Tensor
    operands: Tuple


class _DeviceChains:
    """What every chain on one device shares.  ``stream``: the side stream
    chains are captured on; their kernels count arrivals on its ticket words
    (``_build.tickets``), which hold one launch at a time.  ``lock``:
    serializes captures and replays (and with them the chains' static
    buffers).  ``last``: the stream the last capture or replay was enqueued
    on, which a caller on another stream waits for."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()
        self.last = None

    def order(self, stream) -> None:
        """Order what is next enqueued on ``stream`` after the last capture
        or replay: nothing to do on the same stream."""
        if self.last is not None and self.last != stream:
            stream.wait_stream(self.last)
        self.last = stream


_DEVICE_CHAINS: Dict[torch.device, _DeviceChains] = {}
_DEVICE_CHAINS_LOCK = threading.Lock()


def _device_chains(device: torch.device) -> _DeviceChains:
    dc = _DEVICE_CHAINS.get(device)
    if dc is None:
        with _DEVICE_CHAINS_LOCK:
            dc = _DEVICE_CHAINS.setdefault(device, _DeviceChains(device))
    return dc


def replay_wave(step: _FusedStep, Vmat: torch.Tensor, P0: torch.Tensor,
                iterations: int) -> Optional[torch.Tensor]:
    """``iterations`` fused steps from ``P0`` over ``Vmat`` through the
    graph's chain for this wave's key: ``Vmat`` (and on a warm chain ``P0``)
    copied into the chain's inputs, one graph launch, and a clone of its
    output, which the next replay overwrites.  Without a chain the wave runs
    eagerly on the capture stream, which warms the kernel library, the SM
    count and the stream's ticket words, and the chain is captured after it.

    None where a replay does not apply: CPU tensors, operands the kernels
    would refuse (the eager loop raises on them), or a step bound to other
    device state than the graph's current one (a plan made before a
    refresh)."""
    dev = P0.device
    dom = torch.int32 if step.fmt is not None else torch.float32
    if (dev.type != "cuda" or iterations < 1 or P0.dtype != dom
            or Vmat.dtype != dom or Vmat.device != dev or Vmat.shape != P0.shape
            or P0.dim() != 2 or P0.shape[0] != step.topo.num_rows):
        return None
    rg, warm = step.rg, P0 is not Vmat
    key = (step.fmt, int(P0.shape[1]), step.alpha, iterations, dev, warm)
    dc = _device_chains(dev)
    tl = _trace.armed
    with dc.lock:
        chain = rg.fused_chains.get(key)
        if chain is None:
            current = (rg.fused_topology(), rg.fused_values(step.fmt), rg.fused_dangling())
            if any(a is not b for a, b in zip(step.operands(), current)):
                return None
            return _capture(dc, step, Vmat, P0, iterations, key)
        if any(a is not b for a, b in zip(step.operands(), chain.operands)):
            return None
        t0 = time.perf_counter_ns() if tl is not None else 0
        dc.order(torch.cuda.current_stream(dev))
        chain.vmat.copy_(Vmat)
        if warm:
            chain.p0.copy_(P0)
        chain.graph.replay()
        P = chain.out.clone()
        if tl is not None:
            tl.record(_REPLAY, t0, time.perf_counter_ns())
    fused_ppr_iteration.launches += iterations      # the kernels ran them
    replay_wave.replays += 1
    return P


replay_wave.captures = 0
replay_wave.replays = 0


def _capture(dc: _DeviceChains, step: _FusedStep, Vmat, P0, iterations: int,
             key) -> torch.Tensor:
    """Serve the wave eagerly on the capture stream, then capture its chain
    (torch's side-stream recipe; nothing is allocated or zeroed for the
    ticket words inside the capture: every launch leaves them at zero)."""
    rg, dev, warm = step.rg, P0.device, P0 is not Vmat
    cur = torch.cuda.current_stream(dev)
    dc.order(cur)
    dc.stream.wait_stream(cur)
    with torch.cuda.stream(dc.stream):
        P = P0
        for _ in range(iterations):
            P = step(Vmat, P)
    cur.wait_stream(dc.stream)
    P.record_stream(cur)
    vmat = Vmat.clone()
    p0 = P0.clone() if warm else None
    if rg._chain_pool is None:
        rg._chain_pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=rg._chain_pool, stream=dc.stream,
                          capture_error_mode="thread_local"):
        out = p0 if warm else vmat
        for _ in range(iterations):
            out, _ = fused_ppr_iteration(step.topo, step.val, step.dang_idx, vmat, out,
                                         alpha=step.alpha, fmt=step.fmt)
    fused_ppr_iteration.launches -= iterations      # captured, not run
    rg.fused_chains[key] = FusedChain(graph, vmat, p0, out, step.operands())
    replay_wave.captures += 1
    return P


def _own_vmat(step, own: _FusedStep):
    """``Vmat`` when ``step`` is ``functools.partial(own, Vmat)``, else None."""
    if (isinstance(step, functools.partial) and step.func is own
            and len(step.args) == 1 and not step.keywords):
        return step.args[0]
    return None


def _residual_delta(res, scale: Optional[int]) -> float:
    """max-over-columns L2 state change in value units (``wave_delta`` on the
    kernel's Σd² row — max ∘ sqrt = sqrt ∘ max)."""
    d = float(torch.sqrt(res[2].max()))
    return d / scale if scale else d


def _make_fused_iterate(engine: WaveEngine, iterations: int,
                        convergence: Optional[ConvergencePolicy],
                        fixed: bool, scale: Optional[int], own: _FusedStep,
                        trace_hook=None):
    """Without a policy: the fixed budget, replayed as one CUDA graph when
    the iterate is handed ``functools.partial(own, Vmat)`` on CUDA tensors
    (``replay_wave``), else the engine's eager loop.

    With one: the ``run_until_converged`` contract driven off the kernel's
    fused residual: same check cadence, same exit conditions, same
    parity-correct return states as ``ConvergenceMonitor`` — without its
    per-check full-array device comparisons (the ∞-residual is already on
    device).

    With a ``trace_hook`` the residual of every check is kept, checks before
    ``min_iterations`` included (one host read of the kernel's Σd² row
    each), and the hook gets the same dict on every exit; a hookless wave
    checks only from ``min_iterations`` on, where a check can exit."""
    if convergence is None:
        eager = engine._make_iterate(iterations, None, fixed, scale,
                                     trace_hook=trace_hook)

        def fixed_budget(step, P0):
            Vmat = _own_vmat(step, own)
            P = replay_wave(own, Vmat, P0, iterations) if Vmat is not None else None
            if P is None:
                return eager(step, P0)
            if trace_hook is not None:
                trace_hook({"iterations_run": iterations, "budget": iterations,
                            "early_exit": False})
            return P, iterations

        return fixed_budget
    pol = convergence
    cell = own.cell
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
        step = _FusedStep(rg, None, alpha, {"res": None})
        return WavePlan(
            engine=self.key, fixed=False, scale=None,
            initial=lambda pers: personalization_matrix(num_vertices, pers),
            step=step,
            iterate=_make_fused_iterate(self, iterations, convergence, False,
                                        None, step, trace_hook=trace_hook),
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
        step = _FusedStep(rg, fmt, alpha, {"res": None})
        return WavePlan(
            engine=self.key, fixed=True, scale=fmt.scale,
            initial=lambda pers: personalization_matrix_fixed(
                num_vertices, pers, fmt),
            step=step,
            iterate=_make_fused_iterate(self, iterations, convergence, True,
                                        fmt.scale, step, trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()
        rg.refresh_fused()
