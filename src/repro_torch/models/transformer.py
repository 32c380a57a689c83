"""Model assembly behind one API (counterpart of ``repro.models.transformer``):
the decoder-only families dense (global and local-window layers), moe, ssm
and hybrid.

``build_model(cfg, device)`` returns a ``ModelApi``:

  init_params(generator)                → Transformer (f32 master params, on
                                          the generator's device)
  forward(params, batch)                → logits [B,S,Vp]
  init_cache(batch, max_len)            → decode cache (one dict per layer)
  prefill(params, batch, cache)         → (last_logits [B,Vp], cache)
  decode_step(params, token, pos, cache)→ (logits [B,Vp], cache)

Parameters are ``nn.Module``s, one ``Block`` per layer (the reference stacks
them per pattern segment for ``lax.scan``; ``convert.lm_params_from_jax``
unstacks), and for zamba2 one weight-tied ``shared_attn`` block.  Each
layer's window comes from ``cfg.layer_pattern`` (0 global, W > 0 local,
``MAMBA`` a mamba2 layer).  Activations run in ``cfg.act_dtype`` and every
weight is cast at its use, as in the reference.  The model path runs without
autograd.  Families encdec and vlm, and ``loss_fn``, raise
``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import norm

__all__ = ["ModelApi", "Transformer", "Block", "build_model", "init_params"]

_LATER_FAMILIES = {"encdec": "the encdec (whisper) slice", "vlm": "the vlm slice"}


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init_params: Any
    forward: Any
    loss_fn: Any
    init_cache: Any
    prefill: Any
    decode_step: Any


def init_norm(d: int, kind: str, device=None) -> nn.ParameterDict:
    p = {"w": torch.ones((d,), device=device)}
    if kind != "rmsnorm":
        p["b"] = torch.zeros((d,), device=device)
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in p.items()})


class Block(nn.ModuleDict):
    """One decoder layer of window ``window``.  Attention (``window`` ≥ 0):
    ln1 → attention (→ post_ln1) → residual, ln2 → MLP or MoE (→ post_ln2) →
    residual.  Mamba (``window == MAMBA``): ln1 → mamba2 → residual."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None, window: int = 0):
        if window == MAMBA:
            super().__init__({"ln1": init_norm(cfg.d_model, cfg.norm, device),
                              "mamba": ssm_mod.Mamba(cfg, generator, device)})
            return
        layers = {
            "ln1": init_norm(cfg.d_model, cfg.norm, device),
            "attn": attn_mod.Attention(cfg, generator, device),
            "ln2": init_norm(cfg.d_model, cfg.norm, device),
        }
        if cfg.num_experts:
            layers["moe"] = moe_mod.MoE(cfg, generator, device)
        else:
            layers["mlp"] = moe_mod.MLP(cfg, generator, device)
        if cfg.post_norms:
            layers["post_ln1"] = init_norm(cfg.d_model, cfg.norm, device)
            layers["post_ln2"] = init_norm(cfg.d_model, cfg.norm, device)
        super().__init__(layers)

    def forward(self, h, cfg: ModelConfig, window: int, causal: bool = True):
        if window == MAMBA:
            return h + ssm_mod.mamba_layer(norm(h, self["ln1"], cfg.norm), self["mamba"], cfg)
        a = attn_mod.attention(norm(h, self["ln1"], cfg.norm), self["attn"], cfg,
                               window=window, causal=causal)
        return self.finish(h, a, cfg)

    def finish(self, h, a, cfg: ModelConfig):
        """The layer after its attention output ``a``: post-norm, residual,
        MLP or MoE."""
        if cfg.post_norms:
            a = norm(a, self["post_ln1"], cfg.norm)
        h = h + a
        mi = norm(h, self["ln2"], cfg.norm)
        m = (moe_mod.moe_ffn(mi, self["moe"], cfg) if cfg.num_experts
             else moe_mod.mlp(mi, self["mlp"], cfg))
        if cfg.post_norms:
            m = norm(m, self["post_ln2"], cfg.norm)
        return h + m


class SharedAttention(nn.ModuleDict):
    """zamba2's weight-tied block: ln1 → global attention → residual, ln2 →
    MLP → residual; applied before every ``shared_attn_every`` mamba layers."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None):
        super().__init__({"ln1": init_norm(cfg.d_model, cfg.norm, device),
                          "attn": attn_mod.Attention(cfg, generator, device),
                          "ln2": init_norm(cfg.d_model, cfg.norm, device),
                          "mlp": moe_mod.MLP(cfg, generator, device)})

    def finish(self, h, a, cfg: ModelConfig):
        """The block after its attention output ``a``: residual, MLP."""
        h = h + a
        return h + moe_mod.mlp(norm(h, self["ln2"], cfg.norm), self["mlp"], cfg)

    def forward(self, h, cfg: ModelConfig):
        a = attn_mod.attention(norm(h, self["ln1"], cfg.norm), self["attn"], cfg,
                               window=0, causal=True)
        return self.finish(h, a, cfg)


class Transformer(nn.Module):
    """Embedding [Vp, D] (×0.02), the decoder blocks, the final norm, and an
    unembedding [D, Vp] unless ``tie_embeddings``.  ``generator=None`` leaves
    the values undrawn (for ``device="meta"`` and a later load)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        d = cfg.d_model

        def normal(shape):
            return torch.randn(shape, generator=generator, device=device) * 0.02

        self.embed = nn.Parameter(normal((cfg.padded_vocab, d)), requires_grad=False)
        self.final_norm = init_norm(d, cfg.norm, device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(normal((d, cfg.padded_vocab)),
                                        requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, generator, device, w)
                                    for w in cfg.layer_pattern)
        if cfg.shared_attn_every:
            self.shared_attn = SharedAttention(cfg, generator, device)

    def embed_tokens(self, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """tokens [B,S] → hidden [B,S,D] in ``cfg.act_dtype`` (gathered, then
        cast: the reference casts the whole table first, same values)."""
        h = self.embed[tokens].to(cfg.act_dtype)
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)
        return h

    def logits(self, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = h.to(torch.float32) @ w.to(torch.float32)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return logits


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family in _LATER_FAMILIES:
        raise NotImplementedError(f"the {cfg.family} family ({cfg.name}) is not "
                                  f"ported yet: it comes with {_LATER_FAMILIES[cfg.family]}")


def shared_groups(cfg: ModelConfig):
    """zamba2's interleave: (application index, first layer, stop) for each
    application of the shared block, which runs before layers [first, stop)."""
    every, n = cfg.shared_attn_every, cfg.num_layers
    return [(gi, start, min(start + every, n))
            for gi, start in enumerate(range(0, n, every))]


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Transformer:
    """f32 master parameters drawn from ``generator``, on its device, with the
    reference's distributions (N(0,1)·0.02 embeddings, N(0,1/fan_in) weights,
    unit norms)."""
    _check_supported(cfg)
    return Transformer(cfg, generator, generator.device)


def _tokens(batch, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch["tokens"]), device=device).long()


def build_model(cfg: ModelConfig, device="cuda") -> ModelApi:
    """The model's API on ``device`` (``cuda`` unless the caller asks for the
    CPU; raises without a GPU)."""
    _check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def forward(params: Transformer, batch):
        h = params.embed_tokens(_tokens(batch, dev), cfg)
        if cfg.shared_attn_every:
            for _, start, stop in shared_groups(cfg):
                h = params.shared_attn(h, cfg)
                for block in params.layers[start:stop]:
                    h = block(h, cfg, MAMBA)
        else:
            for block, w in zip(params.layers, cfg.layer_pattern):
                h = block(h, cfg, w)
        h = norm(h, params.final_norm, cfg.norm)
        return params.logits(h, cfg)

    def loss_fn(params, batch):
        raise NotImplementedError("loss_fn (training) is not ported yet: it "
                                  "comes with the training slice")

    from repro_torch.models.decode import build_decode_fns  # late import (cycle)

    init_cache, prefill, decode_step = build_decode_fns(cfg, dev)
    return ModelApi(
        cfg=cfg,
        init_params=functools.partial(init_params, cfg=cfg),
        forward=forward,
        loss_fn=loss_fn,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
