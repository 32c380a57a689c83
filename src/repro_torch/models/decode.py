"""Cached prefill / decode for every family (counterpart of
``repro.models.decode``).

Cache layout (the reference stacks per pattern segment; the port keeps one
entry per layer, of the same shapes and dtypes):
  attention archs : one ``{"k": [B, S, KV, hd], "v": ...}`` per layer, S =
                    max_len, or with ``window_cache=True`` min(window,
                    max_len) for a local layer (a rolling buffer)
  + whisper       : each layer's dict also holds the cross K/V "ck"/"cv"
                    [B, enc_len, KV, hd], filled by prefill from the encoder
  ssm archs       : {"mamba": one ``{"conv": [B, K-1, conv_dim], "ssd":
                    [B, nh, hd, state]}`` per layer}
  zamba2 (hybrid) : that, and "shared": one ``{"k": [B, max_len, KV, hd],
                    "v": ...}`` per application of the shared block

``prefill(params, batch, cache)`` fills the cache for the prompt (whisper:
runs the encoder on ``batch["frames"]``; phi-3-vision: the patches, when
given, take positions 0 … P−1 and the prompt P … P+S−1) and returns the
last position's logits; ``decode_step(params, token, pos, cache)``
advances one token.  Both write the cache in place and return it.  A local
layer whose buffer is no longer than its window is a rolling buffer (the
reference's test, ``decode.py:273``); any other layer's cache holds every
position.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import torch

from repro_torch.configs.base import MAMBA, ModelConfig
from repro_torch.distributed.sharding import shard_activation, write_positions
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import norm
from repro_torch.models.transformer import batch_tensor, run_encoder, shared_groups

Cache = Union[List[Dict[str, torch.Tensor]], Dict[str, Any]]


def _n_shared_apps(cfg: ModelConfig) -> int:
    return -(-cfg.num_layers // cfg.shared_attn_every) if cfg.shared_attn_every else 0


def _rolling(w: int, c: Dict[str, torch.Tensor]) -> bool:
    return bool(w) and c["k"].shape[1] <= w


def build_decode_fns(cfg: ModelConfig, device: torch.device):
    is_ssm = all(w == MAMBA for w in cfg.layer_pattern)
    is_encdec = cfg.enc_layers > 0

    def _kv(batch: int, length: int, dtype, names=("k", "v")) -> Dict[str, torch.Tensor]:
        shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=dtype, device=device) for n in names}

    def init_cache(batch: int, max_len: int, dtype=None,
                   window_cache: bool = False) -> Cache:
        """``window_cache=True`` sizes local-attention layers' K/V as rolling
        buffers of their window."""
        dtype = dtype or cfg.act_dtype
        if is_ssm:
            cache: Dict[str, Any] = {"mamba": [ssm_mod.mamba_init_cache(cfg, batch, device)
                                               for _ in range(cfg.num_layers)]}
            if cfg.shared_attn_every:
                cache["shared"] = [_kv(batch, max_len, dtype)
                                   for _ in range(_n_shared_apps(cfg))]
            return cache
        cache = [_kv(batch, min(w, max_len) if (w and window_cache) else max_len, dtype)
                 for w in cfg.layer_pattern]
        if is_encdec:
            for c in cache:
                c.update(_kv(batch, cfg.enc_len, dtype, ("ck", "cv")))
        return cache

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(params, batch, cache: Cache):
        h = params.embed_inputs(batch, cfg, device)
        enc_out = (run_encoder(params, batch_tensor(batch, "frames", device), cfg)
                   if is_encdec else None)
        if is_ssm:
            h = _prefill_ssm(params, h, cache)
        else:
            for block, w, c in zip(params.layers, cfg.layer_pattern, cache):
                a, k, v = attn_mod.attention(norm(h, block["ln1"], cfg.norm),
                                             block["attn"], cfg, window=w, causal=True,
                                             return_kv=True)
                cross = block.cross_kv(enc_out, cfg) if is_encdec else None
                h = shard_activation(block.finish(h, a, cfg, cross))
                if cross is not None:
                    c["ck"].copy_(cross[0])
                    c["cv"].copy_(cross[1])
                if _rolling(w, c):
                    attn_mod.fill_windowed_cache(c["k"], c["v"], k, v)
                else:
                    write_positions(c["k"], 0, k)
                    write_positions(c["v"], 0, v)
        h = norm(h, params.final_norm, cfg.norm)
        return params.logits(h[:, -1:, :], cfg)[:, 0], cache

    def _prefill_mamba(block, h, c):
        y, state = ssm_mod.mamba_layer_with_state(norm(h, block["ln1"], cfg.norm),
                                                  block["mamba"], cfg)
        c.update(state)
        return shard_activation(h + y)

    def _prefill_ssm(params, h, cache):
        if not cfg.shared_attn_every:
            for block, c in zip(params.layers, cache["mamba"]):
                h = _prefill_mamba(block, h, c)
            return h
        sa = params.shared_attn
        for gi, start, stop in shared_groups(cfg):
            a, k, v = attn_mod.attention(norm(h, sa["ln1"], cfg.norm), sa["attn"], cfg,
                                         window=0, return_kv=True)
            h = shard_activation(sa.finish(h, a, cfg))
            sc = cache["shared"][gi]
            write_positions(sc["k"], 0, k)
            write_positions(sc["v"], 0, v)
            for block, c in zip(params.layers[start:stop], cache["mamba"][start:stop]):
                h = _prefill_mamba(block, h, c)
        return h

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(params, token, pos, cache: Cache):
        """token [B,1] int, pos int (or 0-d tensor) → (logits [B,Vp], cache)."""
        pos = int(pos)
        h = params.embed_tokens(torch.as_tensor(token, device=device).long(), cfg)
        if cfg.learned_pos:
            h = h + params.pos_embed[pos:pos + 1][None].to(h.dtype)
        if is_ssm:
            h = _decode_ssm(params, h, pos, cache)
        else:
            for block, w, c in zip(params.layers, cfg.layer_pattern, cache):
                step = (attn_mod.decode_attention_windowed if _rolling(w, c)
                        else attn_mod.decode_attention)
                a, c["k"], c["v"] = step(norm(h, block["ln1"], cfg.norm), block["attn"],
                                         cfg, c["k"], c["v"], pos, window=w)
                h = shard_activation(
                    block.finish(h, a, cfg, (c["ck"], c["cv"]) if is_encdec else None))
        h = norm(h, params.final_norm, cfg.norm)
        return params.logits(h, cfg)[:, 0], cache

    def _decode_mamba(block, h, c):
        y, state = ssm_mod.mamba_decode_step(norm(h, block["ln1"], cfg.norm),
                                             block["mamba"], cfg, c)
        c.update(state)
        return shard_activation(h + y)

    def _decode_ssm(params, h, pos, cache):
        if not cfg.shared_attn_every:
            for block, c in zip(params.layers, cache["mamba"]):
                h = _decode_mamba(block, h, c)
            return h
        sa = params.shared_attn
        for gi, start, stop in shared_groups(cfg):
            sc = cache["shared"][gi]
            a, sc["k"], sc["v"] = attn_mod.decode_attention(
                norm(h, sa["ln1"], cfg.norm), sa["attn"], cfg, sc["k"], sc["v"], pos,
                window=0)
            h = shard_activation(sa.finish(h, a, cfg))
            for block, c in zip(params.layers[start:stop], cache["mamba"][start:stop]):
                h = _decode_mamba(block, h, c)
        return h

    return init_cache, prefill, decode_step
