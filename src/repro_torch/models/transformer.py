"""Model assembly behind one API (counterpart of ``repro.models.transformer``):
every family of ``configs/archs.py`` — dense (global and local-window
layers), moe, ssm, hybrid, encdec (whisper) and vlm (phi-3-vision).

``build_model(cfg, device, remat)`` returns a ``ModelApi``:

  init_params(generator)                → Transformer (f32 master params, on
                                          the generator's device)
  forward(params, batch)                → logits [B,S,Vp]   (no autograd)
  loss_fn(params, batch)                → scalar            (builds the graph)
  init_cache(batch, max_len)            → decode cache (one dict per layer)
  prefill(params, batch, cache)         → (last_logits [B,Vp], cache)
  decode_step(params, token, pos, cache)→ (logits [B,Vp], cache)

Parameters are ``nn.Module``s, one ``Block`` per layer (the reference stacks
them per pattern segment for ``lax.scan``; ``convert.lm_params_from_jax``
unstacks), for zamba2 one weight-tied ``shared_attn`` block, for whisper an
``encoder`` of non-causal blocks and a cross-attention in every decoder
layer.  Each layer's window comes from ``cfg.layer_pattern`` (0 global,
W > 0 local, ``MAMBA`` a mamba2 layer).  Activations run in
``cfg.act_dtype`` and every weight is cast at its use, as in the reference.

Parameters are created frozen (``requires_grad=False``); training turns
gradients on (``training.init_train_state``).  ``forward``, ``prefill`` and
``decode_step`` run without autograd; ``loss_fn`` builds the graph, and with
``remat=True`` (the reference's ``jax.checkpoint`` of each scanned layer)
recomputes each layer in the backward pass.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_activation, shard_heads, vocab_rows
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import norm

__all__ = ["ModelApi", "Transformer", "Block", "build_model", "init_params"]

POS_EMBED_ROWS = 36864   # the reference's learned-position table (whisper caps at 448)


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
    """One layer of window ``window``.  Attention (``window`` ≥ 0): ln1 →
    attention (→ post_ln1) → residual, [ln_cross → cross-attention →
    residual,] ln2 → MLP or MoE (→ post_ln2) → residual.  Mamba (``window
    == MAMBA``): ln1 → mamba2 → residual."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None, window: int = 0, with_cross: bool = False):
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
        if with_cross:
            layers["ln_cross"] = init_norm(cfg.d_model, cfg.norm, device)
            layers["cross"] = attn_mod.Attention(cfg, generator, device)
        super().__init__(layers)

    def forward(self, h, cfg: ModelConfig, window: int, causal: bool = True,
                enc_out: Optional[torch.Tensor] = None):
        if window == MAMBA:
            return h + ssm_mod.mamba_layer(norm(h, self["ln1"], cfg.norm), self["mamba"], cfg)
        a = attn_mod.attention(norm(h, self["ln1"], cfg.norm), self["attn"], cfg,
                               window=window, causal=causal)
        cross = self.cross_kv(enc_out, cfg) if enc_out is not None else None
        return self.finish(h, a, cfg, cross)

    def cross_kv(self, enc_out: torch.Tensor, cfg: ModelConfig):
        """The encoder output's cross K/V, each [B, enc, KV, hd] in its dtype."""
        b, se, _ = enc_out.shape
        shape = (b, se, cfg.num_kv_heads, cfg.head_dim)
        p = self["cross"]
        kv = cfg.num_kv_heads
        return (shard_heads(enc_out @ p["wk"].to(enc_out.dtype), kv).reshape(shape),
                shard_heads(enc_out @ p["wv"].to(enc_out.dtype), kv).reshape(shape))

    def finish(self, h, a, cfg: ModelConfig, cross=None):
        """The layer after its attention output ``a``: post-norm, residual,
        cross-attention against ``cross`` = (K, V) if given, MLP or MoE."""
        if cfg.post_norms:
            a = norm(a, self["post_ln1"], cfg.norm)
        h = h + a
        if cross is not None:
            h = h + attn_mod.cross_attention_cached(norm(h, self["ln_cross"], cfg.norm),
                                                    self["cross"], cfg, *cross)
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
    unembedding [D, Vp] unless ``tie_embeddings``; ``pos_embed`` [36864, D]
    (×0.01) with ``learned_pos``; whisper's ``encoder`` blocks, ``enc_pos``
    [enc_len, D] (×0.01) and ``enc_final_norm``; phi-3-vision's
    ``patch_proj`` [D, D] (N(0, 1/D)).  ``generator=None`` leaves the values
    undrawn (for ``device="meta"`` and a later load)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        d = cfg.d_model

        def normal(shape, scale):
            return nn.Parameter(torch.randn(shape, generator=generator, device=device)
                                * scale, requires_grad=False)

        self.embed = normal((cfg.padded_vocab, d), 0.02)
        self.final_norm = init_norm(d, cfg.norm, device)
        if not cfg.tie_embeddings:
            self.unembed = normal((d, cfg.padded_vocab), 0.02)
        if cfg.learned_pos:
            self.pos_embed = normal((POS_EMBED_ROWS, d), 0.01)
        self.layers = nn.ModuleList(Block(cfg, generator, device, w, cfg.enc_layers > 0)
                                    for w in cfg.layer_pattern)
        if cfg.shared_attn_every:
            self.shared_attn = SharedAttention(cfg, generator, device)
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(Block(cfg, generator, device)
                                         for _ in range(cfg.enc_layers))
            self.enc_pos = normal((cfg.enc_len, d), 0.01)
            self.enc_final_norm = init_norm(d, cfg.norm, device)
        if cfg.num_patches:
            self.patch_proj = normal((d, d), 1 / math.sqrt(d))

    def embed_tokens(self, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """tokens [B,S] → hidden [B,S,D] in ``cfg.act_dtype`` (gathered, then
        cast: the reference casts the whole table first, same values)."""
        h = vocab_rows(self.embed, tokens).to(cfg.act_dtype)
        if cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)
        return h

    def embed_inputs(self, batch, cfg: ModelConfig, device) -> torch.Tensor:
        """tokens (+ the stub frontend's patch embeddings, before them) →
        initial hidden states [B, P+S, D], learned positions added, pinned by
        ``shard_activation`` (identity unless a sharding context is set)."""
        h = self.embed_tokens(batch_tensor(batch, "tokens", device).long(), cfg)
        if cfg.num_patches and "patches" in batch:
            patches = batch_tensor(batch, "patches", device).to(h.dtype)
            h = torch.cat([patches @ self.patch_proj.to(h.dtype), h], dim=1)
        if cfg.learned_pos:
            h = h + self.pos_embed[:h.shape[1]][None].to(h.dtype)
        return shard_activation(h)

    def logits(self, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = h.to(torch.float32) @ w.to(torch.float32)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return logits


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
    return Transformer(cfg, generator, generator.device)


def batch_tensor(batch, key: str, device) -> torch.Tensor:
    """``batch[key]`` (a tensor, or anything ``np.asarray`` takes) on ``device``."""
    x = batch[key]
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    return torch.as_tensor(a if a.flags.writeable else a.copy(), device=device)


def _layer(block: nn.Module, remat: bool):
    """``block``, recomputed in the backward pass when ``remat`` and autograd
    is recording."""
    if remat and torch.is_grad_enabled():
        return functools.partial(checkpoint, block, use_reentrant=False)
    return block


def run_encoder(params: Transformer, frames: torch.Tensor, cfg: ModelConfig,
                remat: bool = False) -> torch.Tensor:
    """whisper's encoder over precomputed frame embeddings [B, enc, D] (the
    stub conv frontend): non-causal blocks, then ``enc_final_norm``."""
    h = frames.to(cfg.act_dtype) + params.enc_pos[None, :frames.shape[1]].to(cfg.act_dtype)
    for block in params.encoder:
        h = _layer(block, remat)(h, cfg, 0, False)
    return norm(h, params.enc_final_norm, cfg.norm)


def run_decoder(params: Transformer, h: torch.Tensor, cfg: ModelConfig,
                enc_out: Optional[torch.Tensor] = None, remat: bool = False):
    """Every decoder layer over hidden ``h`` (zamba2: the shared block before
    each group of mamba layers, itself not recomputed, as the reference).
    Each layer's output is pinned by ``shard_activation``, as the
    reference's scanned layers are (not zamba2's)."""
    if cfg.shared_attn_every:
        for _, start, stop in shared_groups(cfg):
            h = params.shared_attn(h, cfg)
            for block in params.layers[start:stop]:
                h = _layer(block, remat)(h, cfg, MAMBA)
        return h
    for block, w in zip(params.layers, cfg.layer_pattern):
        h = shard_activation(_layer(block, remat)(h, cfg, w, True, enc_out))
    return h


def build_model(cfg: ModelConfig, device="cuda", remat: bool = True) -> ModelApi:
    """The model's API on ``device`` (``cuda`` unless the caller asks for the
    CPU; raises without a GPU).  ``remat`` recomputes each layer (the
    decoder's, zamba2's mamba layers, and whisper's encoder layers) in
    ``loss_fn``'s backward pass."""
    dev = resolve_device(device)
    is_encdec = cfg.enc_layers > 0

    def _forward(params: Transformer, batch):
        h = params.embed_inputs(batch, cfg, dev)
        enc_out = (run_encoder(params, batch_tensor(batch, "frames", dev), cfg, remat)
                   if is_encdec else None)
        h = run_decoder(params, h, cfg, enc_out, remat)
        h = norm(h, params.final_norm, cfg.norm)
        return params.logits(h, cfg)

    def loss_fn(params: Transformer, batch) -> torch.Tensor:
        """Mean next-token NLL over the targets ≥ 0 (patch positions carry no
        loss), divided by max(#valid, 1), as the reference."""
        logits = _forward(params, batch)
        targets = batch_tensor(batch, "targets", dev).long()
        if cfg.num_patches and "patches" in batch:
            logits = logits[:, cfg.num_patches:]
        valid = targets >= 0
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        # gathered and subtracted with the trailing 1 kept: from vocab-sharded
        # logits the gather is a pending masked sum, whose mask has its shape
        tgt = logits.gather(-1, targets.clamp_min(0).unsqueeze(-1))
        nll = (logz - tgt).squeeze(-1) * valid
        return nll.sum() / valid.sum().clamp_min(1)

    from repro_torch.models.decode import build_decode_fns  # late import (cycle)

    init_cache, prefill, decode_step = build_decode_fns(cfg, dev)
    return ModelApi(
        cfg=cfg,
        init_params=functools.partial(init_params, cfg=cfg),
        forward=torch.no_grad()(_forward),
        loss_fn=loss_fn,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
