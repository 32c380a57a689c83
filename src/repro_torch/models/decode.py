"""Cached prefill / decode for the attention families with the full
(non-windowed) cache (counterpart of ``repro.models.decode``).

Cache layout: one ``{"k": [B, Smax, KV, hd], "v": ...}`` per layer (the
reference stacks them per pattern segment).  ``prefill(params, batch, cache)``
fills the cache for the prompt and returns the last position's logits;
``decode_step(params, token, pos, cache)`` advances one token.  Both write
the cache in place and return it.  ``window_cache=True`` (rolling buffers
for local layers) comes with the windowed-attention slice.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import norm
from repro_torch.models.transformer import _tokens

Cache = List[Dict[str, torch.Tensor]]


def build_decode_fns(cfg: ModelConfig, device: torch.device):
    def init_cache(batch: int, max_len: int, dtype=None,
                   window_cache: bool = False) -> Cache:
        if window_cache:
            raise NotImplementedError("window_cache=True (rolling buffers for "
                                      "local layers) is not ported yet: it comes "
                                      "with the windowed-attention slice")
        dtype = dtype or cfg.act_dtype
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def prefill(params, batch, cache: Cache):
        h = params.embed_tokens(_tokens(batch, device), cfg)
        for block, w, c in zip(params.layers, cfg.layer_pattern, cache):
            a, k, v = attn_mod.attention(norm(h, block["ln1"], cfg.norm),
                                         block["attn"], cfg, window=w, causal=True,
                                         return_kv=True)
            h = block.finish(h, a, cfg)
            c["k"][:, :k.shape[1]] = k.to(c["k"].dtype)
            c["v"][:, :v.shape[1]] = v.to(c["v"].dtype)
        h = norm(h, params.final_norm, cfg.norm)
        return params.logits(h[:, -1:, :], cfg)[:, 0], cache

    @torch.no_grad()
    def decode_step(params, token, pos, cache: Cache):
        """token [B,1] int, pos int (or 0-d tensor) → (logits [B,Vp], cache)."""
        pos = int(pos)
        h = params.embed_tokens(torch.as_tensor(token, device=device).long(), cfg)
        for block, w, c in zip(params.layers, cfg.layer_pattern, cache):
            a, c["k"], c["v"] = attn_mod.decode_attention(
                norm(h, block["ln1"], cfg.norm), block["attn"], cfg,
                c["k"], c["v"], pos, window=w)
            h = block.finish(h, a, cfg)
        h = norm(h, params.final_norm, cfg.norm)
        return params.logits(h, cfg)[:, 0], cache

    return init_cache, prefill, decode_step
