"""Restartable training driver with failure handling (counterpart of
``repro.training.fault_tolerance``).

1. **Checkpoint/restart**: ``run_resumable`` finds the latest atomic
   checkpoint and resumes from it; a crash loses at most ``save_every``
   steps.
2. **Straggler mitigation**: each step's wall time (to a device synchronize)
   feeds an EWMA; steps slower than ``straggler_factor``× the EWMA are
   recorded with their index.  The data are a pure function of the step, so
   a restarted job replays exactly its stream.
3. **Preemption-safe saves**: saves are async and atomic; SIGTERM stops the
   loop after the current step and the pending saves are flushed
   (``checkpoint.wait_pending``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import named_params

__all__ = ["FaultConfig", "run_resumable"]


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    save_every: int = 50
    keep: int = 3
    straggler_factor: float = 2.0
    max_steps: int = 1000


def _wait_for_device(state) -> None:
    """Block until the step's device work is done (the reference's
    ``jax.block_until_ready`` on the first parameter)."""
    dev = next(iter(named_params(state.params).values())).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_resumable(
    fault_cfg: FaultConfig,
    init_state_fn: Callable[[], Any],
    train_step,
    batch_fn: Callable[[int], Any],
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    fail_at_step: Optional[int] = None,   # test hook: simulated node failure
):
    """Run (or resume) training with periodic async checkpoints.

    Returns (final_state, steps_run_this_invocation, straggler_steps)."""
    last = ckpt.latest_step(fault_cfg.ckpt_dir)
    if last is not None:
        state = ckpt.restore(fault_cfg.ckpt_dir, last, init_state_fn())
        start = last
    else:
        state = init_state_fn()
        start = 0

    stop = {"flag": False}

    def _sigterm(signum, frame):   # preemption: flush and exit cleanly
        stop["flag"] = True

    old = signal.signal(signal.SIGTERM, _sigterm)
    ewma = None
    stragglers = []
    steps_run = 0
    try:
        for step in range(start, fault_cfg.max_steps):
            if stop["flag"]:
                break
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"simulated node failure at step {step}")
            t0 = time.monotonic()
            state, metrics = train_step(state, batch_fn(step))
            _wait_for_device(state)
            dt = time.monotonic() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > fault_cfg.straggler_factor * ewma and step > start + 3:
                stragglers.append((step, dt, ewma))
            steps_run += 1
            if on_metrics:
                on_metrics(step, metrics)
            if (step + 1) % fault_cfg.save_every == 0:
                ckpt.save_async(fault_cfg.ckpt_dir, step + 1, state, keep=fault_cfg.keep)
    finally:
        ckpt.wait_pending()
        signal.signal(signal.SIGTERM, old)
    return state, steps_run, stragglers
