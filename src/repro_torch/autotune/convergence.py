"""Early-exit convergence monitoring on the step-driven PPR drivers (Fig. 7).

Counterpart of ``repro.autotune.convergence``; states are torch tensors
(raw fixed-point states are int32 tensors of uint32 bits).

The paper's Fig. 7 observation: fixed-point PPR does not merely approach the
stationary distribution — it reaches an *absorbing state* in fewer iterations
than float32 needs to pass the 1e-6 threshold, because every further update
underflows the 2^-f grid.  A service that always runs its full iteration
budget therefore wastes the paper's "additional 2x speedup".

Empirically (and reproducibly with this repo's bit-exact datapath) the
absorbing state takes one of two shapes:

- a strict fixed point: one more eq. (1) iteration reproduces P bit-for-bit
  (checked by exact integer comparison — the float delta statistic cannot be
  trusted here, since casting raw uint32 to float32 rounds a 1-LSB change at
  raw values ≥ 2^24 to delta == 0); or
- a **period-2 absorbing cycle**: a handful of entries flip by one LSB each
  iteration and flip back (truncation alternately rounds them down and re-adds
  the lost mass), so consecutive states alternate A, B, A, B, … and the delta
  freezes at a constant value on the quantization noise floor.

Both are detected exactly.  The cycle case still permits *bit-identical* early
exit: once S_t == S_{t-2} is observed, every later state is determined by
parity, so the monitor returns S_t or S_{t-1} according to the parity of the
remaining budget — the result equals the full-budget run bit-for-bit, just
without running it.

The float32 path exits below ``epsilon`` (the paper's Fig. 7 threshold); its
ranks may differ microscopically from the full-budget run, which is why the
service's shadow estimator (repro.autotune.quality) keeps scoring served
results online.

The delta is the same statistic the core scan drivers trace: max over the κ
columns of the L2 norm of the state change, in value units (raw fixed-point
deltas are divided by the format scale).  Each check forces one device sync;
``check_every`` amortizes that for long budgets.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.fixed_point import widen_u32

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ConvergencePolicy:
    """When may a wave stop iterating early?

    ``epsilon``        float-path L2 threshold.  The fixed path ignores it:
                       only the exact absorbing state / absorbing cycle stops
                       a fixed wave (those exits are bit-identical, free wins).
    ``min_iterations`` never exit before this many iterations have run.
    ``check_every``    test for convergence every k-th iteration only (each
                       check is a host sync on the wave's state).
    """
    epsilon: float = 1e-6
    min_iterations: int = 2
    check_every: int = 1

    def __post_init__(self):
        if self.min_iterations < 1:
            raise ValueError("min_iterations must be >= 1")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")


def wave_delta(P_new: Array, P_prev: Array, scale: Optional[int] = None) -> float:
    """Max-over-columns L2 state change in value units — the statistic the core
    loop drivers trace, recomputed between two step-driver states.
    ``scale`` converts raw fixed-point deltas (pass ``fmt.scale``)."""
    if P_new.dtype == torch.int32:   # raw uint32 bits → their values
        P_new, P_prev = widen_u32(P_new), widen_u32(P_prev)
    d = P_new.to(torch.float32) - P_prev.to(torch.float32)
    delta = torch.sqrt((d * d).sum(0)).max()
    if scale is not None:
        delta = delta / scale
    return float(delta)


def states_equal(a: Array, b: Array) -> bool:
    """Bit-exact state equality (one device reduction)."""
    return bool(torch.equal(a, b))


class ConvergenceMonitor:
    """Stateful per-wave monitor: feed consecutive states, learn when to stop.

    ``update`` returns True once the wave may exit; ``cycle`` is then True when
    the exit was a period-2 absorbing cycle rather than a strict fixed point
    (the driver must pick the parity-correct state in that case).
    """

    def __init__(self, policy: ConvergencePolicy, *, fixed: bool,
                 scale: Optional[int] = None, track_deltas: bool = True):
        self.policy = policy
        self.fixed = fixed
        self.scale = scale
        # The fixed path converges on exact integer comparisons; its float
        # delta is telemetry only.  A driver that discards the trace (the
        # serving hot path) passes track_deltas=False to skip that second
        # full-array reduction + host sync per checked iteration.  The float
        # path always computes the delta — it *is* the exit criterion there.
        self.track_deltas = track_deltas
        self.iterations = 0
        self.deltas: List[float] = []
        self.converged = False
        self.cycle = False
        self._prev2: Optional[Array] = None    # S_{t-2}, fixed path only

    def update(self, P_new: Array, P_prev: Array) -> bool:
        """Record one completed iteration (S_{t-1} → S_t); True ⇒ may stop."""
        self.iterations += 1
        if self.converged:
            return True
        checking = self.iterations % self.policy.check_every == 0
        prev2 = self._prev2
        if self.fixed:
            self._prev2 = P_prev                # keep S_{t-1} as next S_{t-2}
        if not checking:
            return False                        # skip the host syncs
        if self.fixed:
            # The strict check must be exact integer equality, not the float
            # delta: ``wave_delta`` casts raw uint32 to float32, so for raw
            # values >= 2^24 (scores >= 0.5 in Q1.25) a 1-LSB state change
            # rounds to delta == 0.0 and a "bit-identical" exit would return
            # a non-fixed-point.  The float delta is telemetry-only here, and
            # its reduction is skipped when exact equality already proves it 0.
            strict = states_equal(P_new, P_prev)
            if self.track_deltas:
                self.deltas.append(
                    0.0 if strict else wave_delta(P_new, P_prev, self.scale))
            if self.iterations < self.policy.min_iterations:
                return False
            if strict:                          # strict absorbing state
                self.converged = True
            elif prev2 is not None and states_equal(P_new, prev2):
                self.converged = self.cycle = True
        else:
            delta = wave_delta(P_new, P_prev, self.scale)
            self.deltas.append(delta)
            if self.iterations < self.policy.min_iterations:
                return False
            self.converged = delta < self.policy.epsilon
        return self.converged


def run_until_converged(
    step: Callable[[Array], Array],
    P0: Array,
    max_iterations: int,
    policy: ConvergencePolicy,
    *,
    fixed: bool,
    scale: Optional[int] = None,
    track_deltas: bool = True,
) -> Tuple[Array, int, List[float]]:
    """Drive one eq. (1) step function until convergence or budget exhaustion.

    Returns (final state, iterations actually run, observed deltas).  Fixed
    point exits are bit-identical to the full-budget run: a strict absorbing
    state is a fixed point of ``step``, and on a period-2 absorbing cycle the
    full-budget result is recovered by parity (S_B = S_t when B ≡ t mod 2,
    else S_{t-1}).  ``track_deltas=False`` skips the fixed path's
    telemetry-only delta reductions; the returned trace is then empty there."""
    monitor = ConvergenceMonitor(policy, fixed=fixed, scale=scale,
                                 track_deltas=track_deltas)
    P = P0
    for t in range(1, max_iterations + 1):
        P_next = step(P)                        # P = S_{t-1}, P_next = S_t
        if monitor.update(P_next, P):
            if monitor.cycle and (max_iterations - t) % 2 != 0:
                return P, t, monitor.deltas     # parity lands on S_{t-1}
            return P_next, t, monitor.deltas
        P = P_next
    return P, max_iterations, monitor.deltas
