"""train_step factory: microbatched gradient accumulation, optional
fixed-point gradient compression with error feedback, then AdamW
(counterpart of ``repro.training.train_loop``).

The step is eager: each microbatch's backward accumulates into the
parameters' ``.grad`` (float32, as the masters), the sum is divided by the
microbatch count, compressed when asked, and AdamW updates the parameters
and moments in place.  Activation memory goes as 1/m.  Compression is
``core.quantization.ErrorFeedbackQuantizer``'s, done in place on the
residual so that a step holds no second copy of it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.quantization import truncate_to_grid
from repro_torch.training.optimizer import (
    AdamState,
    AdamWConfig,
    adamw_update,
    init_opt_state,
    named_params,
)

__all__ = ["TrainState", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    params: Any                                   # Transformer (or a dict of tensors)
    opt: AdamState
    residual: Optional[Dict[str, torch.Tensor]]   # error-feedback residual, or None


def init_train_state(params, compress: bool = False) -> TrainState:
    """Turns the parameters' gradients on and zeroes μ, ν (and the
    compression residual when ``compress``)."""
    named = named_params(params)
    for p in named.values():
        p.requires_grad_(True)
    res = {k: torch.zeros_like(p) for k, p in named.items()} if compress else None
    return TrainState(params=params, opt=init_opt_state(params), residual=res)


def _rows(x: torch.Tensor, i: int, microbatches: int) -> torch.Tensor:
    """Microbatch ``i``: rows [i·n, (i+1)·n).  A DTensor whose rows are
    sharded gives each device the i-th part of its own rows instead, so that
    no device gathers the batch.  The microbatches then group the rows
    otherwise than the reference's; the step is the same wherever each
    microbatch counts as many targets (every synthetic batch does), since
    it averages the microbatches' mean losses.  Each device's rows must
    split into ``microbatches`` equal parts: the batch must divide by the
    microbatches times the devices that share its rows."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and any(p.is_shard(0) for p in x.placements):
        shards = 1
        for axis, p in enumerate(x.placements):
            if p.is_shard(0):
                shards *= x.device_mesh.size(axis)
        if x.shape[0] % (microbatches * shards):
            raise ValueError(
                f"a batch of {x.shape[0]} rows sharded over {shards} devices does not "
                f"split into {microbatches} equal microbatches on each device")
        loc = x.to_local()
        n = loc.shape[0] // microbatches
        return DTensor.from_local(loc[i * n:(i + 1) * n], x.device_mesh, x.placements,
                                  run_check=False)
    n = x.shape[0] // microbatches
    return x[i * n:(i + 1) * n]


def _split(batch, microbatches: int):
    """The batch's leaves split along dim 0 into ``microbatches`` equal parts
    (the reference's reshape to [m, B/m, …]: B must divide)."""
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"a batch of {b} does not split into {microbatches} "
                         f"equal microbatches")
    return [{k: _rows(x, i, microbatches) for k, x in batch.items()}
            for i in range(microbatches)]


def make_train_step(loss_fn, opt_cfg: AdamWConfig, microbatches: int = 1,
                    grad_compress_bits: int = 0):
    """loss_fn(params, batch) → scalar.  Returns train_step(state, batch) →
    (state, {loss, grad_norm, lr}); the state's tensors are updated in place."""

    def train_step(state: TrainState, batch):
        named = named_params(state.params)
        for p in named.values():
            p.grad = None
        loss = None
        for mb in _split(batch, microbatches) if microbatches > 1 else [batch]:
            mb_loss = loss_fn(state.params, mb)
            mb_loss.backward()
            loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
        grads = {}
        for k, p in named.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads[k] = g / microbatches if microbatches > 1 else g
        if microbatches > 1:
            loss = loss / microbatches

        residual = state.residual
        if grad_compress_bits and residual is not None:
            # the paper's truncation quantizer with error feedback
            for k, g in grads.items():
                residual[k].add_(g)                  # g + r
                grads[k] = truncate_to_grid(residual[k], grad_compress_bits)
                residual[k].sub_(grads[k])           # (g + r) − q

        params, opt, metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        del grads
        return TrainState(params, opt, residual), dict(metrics, loss=loss)

    return train_step
