"""AdamW + cosine schedule + global-norm clipping, written out (counterpart of
``repro.training.optimizer``; not ``torch.optim.AdamW``, whose ε placement
and decay order differ from the reference's).

Parameters are a ``Transformer`` (its ``named_parameters``) or a dict of
tensors; gradients and the moments μ, ν are dicts keyed by the same names.
``adamw_update`` writes the parameters and moments in place, one tensor at a
time, so a step holds no second copy of them (gemma-2b: 10 GB of f32
masters, as much again for each moment).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

__all__ = ["AdamWConfig", "AdamState", "schedule", "init_opt_state", "global_norm",
           "adamw_update", "named_params"]

Params = Union[nn.Module, Dict[str, torch.Tensor]]


class AdamState(NamedTuple):
    step: torch.Tensor                 # 0-d int32, on the parameters' device
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """name → tensor for a module's parameters or a dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``·lr; float32,
    on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: Params) -> AdamState:
    named = named_params(params)
    dev = next(iter(named.values())).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu={k: torch.zeros_like(p) for k, p in named.items()},
                     nu={k: torch.zeros_like(p) for k, p in named.items()})


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], state: AdamState,
                 params: Params) -> Tuple[Params, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step: clip by the global norm, min(1, clip / (‖g‖ + 1e-9));
    bias corrections from the step as float32; the decoupled decay inside the
    update, p − lr·(m̂/(√v̂+ε) + wd·p).  Writes ``params``, μ and ν in place
    and returns (params, new state, {grad_norm, lr}); ``grads`` are left as
    they are."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for name, p in named_params(params).items():
        g = grads[name] * scale
        m, v = state.mu[name], state.nu[name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        upd.add_(cfg.weight_decay * p)
        p.sub_(lr * upd)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm,
                                                                   "lr": lr}
