from repro_torch.training.checkpoint import (
    latest_step,
    restore,
    save,
    save_async,
    wait_pending,
)
from repro_torch.training.fault_tolerance import FaultConfig, run_resumable
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.training.train_loop import TrainState, init_train_state, make_train_step

__all__ = [
    "AdamWConfig", "adamw_update", "init_opt_state",
    "TrainState", "init_train_state", "make_train_step",
    "save", "save_async", "restore", "latest_step", "wait_pending",
    "FaultConfig", "run_resumable",
]
