"""Dense MLP and Mixture-of-Experts feed-forward (counterpart of
``repro.models.moe``).

MoE dispatch is the paper's COO SpMM: the token→expert-slot assignment is a
sparse matrix with entries (dst = expert·capacity + rank, src = token, val =
gate weight); dispatch multiplies it against the activations, combine
multiplies its transpose.  As in the reference: tokens sorted by expert
(stably: the rank within an expert, and with it which tokens the capacity
drops, follows token order), capacity-bounded slots, scatter/gather and the
gate-weighted combine.  Each batch row is dispatched on its own.

Under a sharding context (``distributed.sharding``) the dispatch and the
combine run as each device's own program on its batch rows
(``local_region``): the sort, ``searchsorted`` and the slot scatter have no
DTensor sharding rule, and a row's routing needs the whole row, so the
sequence is gathered first, as the reference's program gathers it.  The
expert buffers are pinned where the reference pins them (``constrain`` by
``moe_mode``: experts → "model" in EP, d_ff → "model" in TP).  With no
context every one of these is the identity.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    batch_axes,
    constrain,
    local_region,
    model_if_divides,
    moe_mode,
)
from repro_torch.models.common import act_fn, dense_init

__all__ = ["MLP", "MoE", "init_mlp", "init_moe", "mlp", "moe_ffn", "route",
           "dispatch", "experts", "combine", "router_aux_loss"]


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
    # under a sharding context the input is gathered once and whole on each
    # model device, the hidden units lie over the model axis (column-, then
    # row-parallel: no weight moves)
    dp = batch_axes(x.shape[0])
    x, ff = constrain(x, (dp,)), (dp, None, model_if_divides(cfg.d_ff))
    if cfg.mlp == "glu":
        h = act_fn(x @ p["w_gate"].to(x.dtype), cfg.act) * (x @ p["w_up"].to(x.dtype))
        return constrain(h, ff) @ p["w_down"].to(x.dtype)
    h = act_fn(x @ p["w_fc"].to(x.dtype) + p["b_fc"].to(x.dtype), cfg.act)
    return constrain(h, ff) @ p["w_proj"].to(x.dtype) + p["b_proj"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
class MoE(nn.ParameterDict):
    """router [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D]; float32
    masters drawn as ``dense_init``."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None):
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        p = {"router": dense_init((d, e), d, generator, device),
             "w_gate": dense_init((e, d, f), d, generator, device),
             "w_up": dense_init((e, d, f), d, generator, device),
             "w_down": dense_init((e, f, d), f, generator, device)}
        super().__init__({k: nn.Parameter(t, requires_grad=False) for k, t in p.items()})


def init_moe(cfg: ModelConfig, generator: Optional[torch.Generator], device=None) -> MoE:
    return MoE(cfg, generator, device)


def _capacity(tokens: int, cfg: ModelConfig, capacity_factor: float) -> int:
    c = math.ceil(tokens * cfg.experts_per_token * capacity_factor / cfg.num_experts)
    return max(1, min(tokens, (c + 3) // 4 * 4))


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (gate values [B, S, k] float32, expert ids [B, S, k]):
    softmax in float32, the top k renormalised.  A stable descending sort
    breaks ties by the lower expert id, as ``jax.lax.top_k`` does."""
    logits = x @ router.to(x.dtype)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_val, top_idx = vals[..., :k], idx[..., :k]
    return top_val / top_val.sum(-1, keepdim=True).clamp_min(1e-9), top_idx


def dispatch(top_idx: torch.Tensor, top_val: torch.Tensor, cap: int, num_experts: int,
             dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The COO build, per batch row: entries (dst = slot, src = token, val =
    gate) in dst-major (ascending expert) order.  Returns (slot, token, gate),
    each [B, S·k]; an entry past its expert's capacity gets the overflow slot
    ``E·cap`` (dropped)."""
    b, s, k = top_idx.shape
    n = s * k
    expert_flat = top_idx.reshape(b, n)
    token_flat = torch.arange(s, device=top_idx.device).repeat_interleave(k)
    gate_flat = top_val.reshape(b, n).to(dtype)
    order = torch.argsort(expert_flat, dim=-1, stable=True)    # dst-major stream order
    es = expert_flat.gather(1, order)
    ts = token_flat[order]
    gs = gate_flat.gather(1, order)
    # rank within an expert = position in its sorted run (capacity = packet pad)
    rank = torch.arange(n, device=top_idx.device) - torch.searchsorted(es, es, side="left")
    slot = torch.where(rank < cap, es * cap + rank, num_experts * cap)
    return slot, ts, gs


def scatter_slots(x: torch.Tensor, slot, ts, num_experts: int, cap: int) -> torch.Tensor:
    """Scatter the tokens into their slots: [B, E, cap, D]."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    xe = torch.zeros((b, num_experts * cap + 1, d), dtype=x.dtype, device=x.device)
    xe[rows, slot] = x[rows, ts]      # the overflow row takes duplicates; discarded
    return xe[:, :-1].reshape(b, num_experts, cap, d)


def expert_glu(xe: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's GLU on its slots [B, E, cap, D] (each expert's weights
    cast at the use), the buffers pinned by ``moe_mode`` under a context."""
    mode, dp = moe_mode(cfg.num_experts), batch_axes(xe.shape[0])
    pin = {"ep": ((dp, "model"), (dp, "model"), (dp, "model")),
           "tp": ((dp,), (dp, None, None, "model"), (dp,))}.get(mode)
    if pin:
        xe = constrain(xe, pin[0])
    h = act_fn(torch.einsum("becd,edf->becf", xe, p["w_gate"].to(xe.dtype)), cfg.act)
    h = h * torch.einsum("becd,edf->becf", xe, p["w_up"].to(xe.dtype))
    if pin:
        h = constrain(h, pin[1])
    ye = torch.einsum("becf,efd->becd", h, p["w_down"].to(xe.dtype))
    return constrain(ye, pin[2]) if pin else ye


def experts(x: torch.Tensor, p, cfg: ModelConfig, cap: int, slot, ts) -> torch.Tensor:
    """Scatter the tokens into their slots [B, E, cap, D] and run every
    expert's GLU on its slots."""
    return expert_glu(scatter_slots(x, slot, ts, cfg.num_experts, cap), p, cfg)


def combine(ye: torch.Tensor, slot, ts, gs, s: int) -> torch.Tensor:
    """The transpose: out[t] = Σ gate · ye[slot] over token t's k entries,
    in ascending expert order (the order in which the reference's scatter-add
    applies them), so the sum is deterministic on the card."""
    b, e, cap, d = ye.shape
    flat = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros((b, 1, d))], dim=1)
    # a stable sort by token keeps each token's entries in expert order
    by_token = torch.argsort(ts, dim=-1, stable=True)
    rows = torch.arange(b, device=ye.device)[:, None]
    contrib = flat[rows, slot.gather(1, by_token)] * gs.gather(1, by_token)[..., None]
    contrib = contrib.reshape(b, s, -1, d)
    out = contrib[:, :, 0]
    for j in range(1, contrib.shape[2]):
        out = out + contrib[:, :, j]
    return out


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig, capacity_factor: float = 0.0
            ) -> torch.Tensor:
    """x [B, S, D] → [B, S, D]; top-k routing with capacity, COO-form
    dispatch."""
    s, e = x.shape[1], cfg.num_experts
    cap = _capacity(s, cfg, capacity_factor or cfg.moe_capacity_factor)
    rows = (batch_axes(x.shape[0]),)       # [B, ...] spec: batch rows sharded, rest whole
    x = constrain(x, rows)
    top_val, top_idx = route(x, p["router"], cfg)
    slot, ts, gs = local_region(dispatch, (rows, rows, None, None, None),
                                [rows, rows, rows])(top_idx, top_val, cap, e, x.dtype)
    xe = local_region(scatter_slots, (rows, rows, rows, None, None),
                      rows)(x, slot, ts, e, cap)
    ye = constrain(expert_glu(xe, p, cfg), rows)
    return local_region(combine, (rows, rows, rows, rows, None), rows)(ye, slot, ts, gs, s)


def router_aux_loss(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E · Σ_e f_e · P_e."""
    logits = x @ p["router"].to(x.dtype)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    frac = torch.nn.functional.one_hot(top1, cfg.num_experts).to(torch.float32).mean((0, 1))
    prob = gates.mean((0, 1))
    return cfg.num_experts * torch.sum(frac * prob)
