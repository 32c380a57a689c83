"""Dense feed-forward (counterpart of ``repro.models.moe``, dense MLP only).

Mixture-of-experts routing (the reference's COO-form dispatch) comes with the
MoE slice; ``moe_ffn`` raises until then.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act_fn, dense_init

__all__ = ["MLP", "init_mlp", "mlp", "moe_ffn"]


class MLP(nn.ParameterDict):
    """glu: w_gate/w_up [D, F], w_down [F, D]; plain: w_fc/b_fc, w_proj/b_proj."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None):
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp == "glu":
            p = {"w_gate": dense_init((d, f), d, generator, device),
                 "w_up": dense_init((d, f), d, generator, device),
                 "w_down": dense_init((f, d), f, generator, device)}
        else:
            p = {"w_fc": dense_init((d, f), d, generator, device),
                 "b_fc": torch.zeros((f,), device=device),
                 "w_proj": dense_init((f, d), f, generator, device),
                 "b_proj": torch.zeros((d,), device=device)}
        super().__init__({k: nn.Parameter(t, requires_grad=False) for k, t in p.items()})


def init_mlp(cfg: ModelConfig, generator: Optional[torch.Generator], device=None) -> MLP:
    return MLP(cfg, generator, device)


def mlp(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "glu":
        h = act_fn(x @ p["w_gate"].to(x.dtype), cfg.act) * (x @ p["w_up"].to(x.dtype))
        return h @ p["w_down"].to(x.dtype)
    h = act_fn(x @ p["w_fc"].to(x.dtype) + p["b_fc"].to(x.dtype), cfg.act)
    return h @ p["w_proj"].to(x.dtype) + p["b_proj"].to(x.dtype)


def moe_ffn(x, p, cfg: ModelConfig, capacity_factor: float = 0.0):
    raise NotImplementedError("mixture-of-experts feed-forward is not ported "
                              "yet: it comes with the MoE slice")
