"""Early-exit convergence for wave iterations (counterpart of
``repro.autotune``; the adaptive-precision controller and shadow quality
estimator come with the autotune slice)."""
from repro_torch.autotune.convergence import (
    ConvergenceMonitor,
    ConvergencePolicy,
    run_until_converged,
    states_equal,
    wave_delta,
)

__all__ = ["ConvergencePolicy", "ConvergenceMonitor", "run_until_converged",
           "states_equal", "wave_delta"]
