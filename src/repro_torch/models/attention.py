"""Attention: GQA/MQA, local (sliding-window) and global, softcap, qk-norm,
query-chunked prefill and cached decode, full or rolling-window caches
(counterpart of ``repro.models.attention``).

Local layers slice K/V to ``window + qc`` positions per query chunk, as the
reference does (there a ``dynamic_slice``, here plain slicing: the port is
eager).  ``cross_attention_cached`` is whisper's decoder cross-attention
against the encoder's K/V (no mask, no rope, no softcap).
``_attend`` keeps the reference's einsum form (scores in the input dtype,
softmax in float32); the model path does not call the flash kernel, as the
reference's does not call its Pallas one.  Each projection passes
``shard_heads`` before it is split into heads (the identity unless a
sharding context is set).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    batch_axes,
    constrain,
    heads_layout,
    local_region,
    model_start,
    shard_heads,
    write_positions,
)
from repro_torch.models.common import dense_init, rmsnorm, rope, softcap

__all__ = ["Attention", "attention", "prefill_kv", "decode_attention",
           "decode_attention_windowed", "fill_windowed_cache",
           "cross_attention_cached"]


class Attention(nn.ParameterDict):
    """wq [D, H·hd], wk/wv [D, KV·hd], wo [H·hd, D] (+ q_norm/k_norm), float32
    masters drawn as ``dense_init``; read by name like the reference's dict."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None):
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        p = {
            "wq": dense_init((d, h * hd), d, generator, device),
            "wk": dense_init((d, kv * hd), d, generator, device),
            "wv": dense_init((d, kv * hd), d, generator, device),
            "wo": dense_init((h * hd, d), h * hd, generator, device),
        }
        if cfg.use_qk_norm:
            p["q_norm"] = torch.ones((hd,), device=device)
            p["k_norm"] = torch.ones((hd,), device=device)
        super().__init__({k: nn.Parameter(t, requires_grad=False) for k, t in p.items()})


def _project_qkv(x, p, cfg: ModelConfig, positions):
    """x [B,S,D] → q [B,S,H,hd], k/v [B,S,KV,hd] with rope/qk-norm applied."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # every layout follows the kv heads: q is split into kv groups later;
    # the input is gathered once for the three projections
    x = constrain(x, (batch_axes(b),))
    q = shard_heads(x @ p["wq"].to(x.dtype), kv).reshape(b, s, h, hd)
    k = shard_heads(x @ p["wk"].to(x.dtype), kv).reshape(b, s, kv, hd)
    v = shard_heads(x @ p["wv"].to(x.dtype), kv).reshape(b, s, kv, hd)
    if cfg.use_qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if not cfg.learned_pos:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return shard_heads(q, kv), shard_heads(k, kv), v


def _attend(q, k, v, qpos, kpos, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """Masked GQA attention.  q [B,qc,H,hd]; k/v [B,Skv,KV,hd];
    qpos [qc], kpos [Skv] global positions (mask = causal)."""
    b, qc, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, qc, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    mask = torch.ones((qc, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    mask &= kpos[None, :] >= 0  # padding slots in sliced windows carry kpos=-1
    scores = torch.where(mask[None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, qc, h, hd)


def _attend_window(q_chunk, k, v, chunk_start: int, cfg: ModelConfig, causal: bool,
                   window: int) -> torch.Tensor:
    """Local attention: slice K/V to [chunk_start-window, chunk_start+qc),
    clipped into the sequence — ``window + qc`` positions, sub-quadratic."""
    qc = q_chunk.shape[1]
    s = k.shape[1]
    span = min(window + qc, s)
    start = min(max(chunk_start - window, 0), s - span)
    qpos = chunk_start + torch.arange(qc, device=q_chunk.device)
    kpos = start + torch.arange(span, device=q_chunk.device)
    return _attend_masked_window(q_chunk, k[:, start:start + span],
                                 v[:, start:start + span], qpos, kpos, cfg, causal, window)


def _attend_masked_window(q, k, v, qpos, kpos, cfg: ModelConfig, causal: bool,
                          window: int) -> torch.Tensor:
    """``_attend`` with the window mask ``qpos − kpos < window``."""
    b, qc, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, qc, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
    else:
        mask = torch.ones((qc, k.shape[1]), dtype=torch.bool, device=q.device)
    mask &= qpos[:, None] - kpos[None, :] < window
    scores = torch.where(mask[None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(b, qc, h, hd)


def _attend_chunks(q, k, v, cfg: ModelConfig, causal: bool, window: int, chunk: int,
                   q_start: int) -> torch.Tensor:
    """q [B, Sq, H, hd], the positions q_start … q_start+Sq−1, against k/v
    [B, S, KV, hd] in query chunks of the largest divisor of Sq that is ≤
    ``chunk`` (e.g. 1500 → 500) → [B, Sq, H, hd]."""
    s = k.shape[1]
    qc = min(chunk, q.shape[1])
    while q.shape[1] % qc:
        qc -= 1
    kpos_full = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, q.shape[1], qc):
        qi = q[:, start:start + qc]
        if window and window < s:
            outs.append(_attend_window(qi, k, v, q_start + start, cfg, causal, window))
        else:
            qpos = q_start + start + torch.arange(qc, device=q.device)
            outs.append(_attend(qi, k, v, qpos, kpos_full, cfg, causal))
    return torch.cat(outs, dim=1)


def attention(x, p, cfg: ModelConfig, *, window: int, causal: bool = True,
              chunk: int = 512, return_kv: bool = False):
    """Training/prefill attention over a full sequence.  x [B,S,D] → [B,S,D].

    Queries go in chunks of the largest divisor of S that is ≤ ``chunk``, as
    in the reference (there a scan, here a loop).  Under a sharding context
    whose model axis holds positions (the kv heads do not divide it), each
    device attends its own query positions to the whole K/V, in chunks of
    its own: a region of one device's program, whose K/V gradients are its
    share of a sum over the model axis."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions)
    kv = cfg.num_kv_heads
    if heads_layout(kv, s) == "positions":
        dp = batch_axes(b)
        mine = functools.partial(_attend_chunks, cfg=cfg, causal=causal, window=window,
                                 chunk=chunk, q_start=model_start(s))
        out = local_region(mine, ((dp, "model"), (dp,), (dp,)), (dp, "model"),
                           partial_grads={1: "model", 2: "model"})(q, k, v)
    else:
        out = _attend_chunks(q, k, v, cfg, causal, window, chunk, 0)
    out = shard_heads(out, kv)
    out = shard_heads(out.reshape(b, s, cfg.num_heads * cfg.head_dim), kv)
    y = out @ p["wo"].to(x.dtype)
    if return_kv:
        return y, k, v
    return y


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
def prefill_kv(x, p, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project K/V for the whole prompt (cache fill)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    _, k, v = _project_qkv(x, p, cfg, positions)
    return k, v


def decode_attention(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                     window: int):
    """One-token attention against the cache; returns (out, cache_k, cache_v).

    x [B, 1, D]; cache_k/v [B, Smax, KV, hd].  The new K/V row is written
    into the caches in place (the reference returns updated copies)."""
    q = _write_row(x, p, cfg, cache_k, cache_v, pos, pos)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    valid = kpos <= pos
    if window:
        valid &= kpos > pos - window
    return _attend_cached(x, q, p, cfg, cache_k, cache_v, valid), cache_k, cache_v


def _write_row(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int, slot: int):
    """Project the token at ``pos`` and write its K/V row at ``slot``; → q."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    write_positions(cache_k, slot, k_new)
    write_positions(cache_v, slot, v_new)
    return q


def _attend_cached(x, q, p, cfg: ModelConfig, cache_k, cache_v, valid) -> torch.Tensor:
    """One query row against the cache's ``valid`` slots, then ``wo``."""
    b = x.shape[0]
    kvh, hd, h = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          cache_k.to(q.dtype)).to(torch.float32)
    scores = softcap(scores / math.sqrt(hd), cfg.attn_softcap)
    scores = torch.where(valid[None, None, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = shard_heads(torch.einsum("bkgqs,bskd->bqkgd", w, cache_v.to(q.dtype)), kvh)
    return shard_heads(out.reshape(b, 1, h * hd), kvh) @ p["wo"].to(x.dtype)


def decode_attention_windowed(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                              window: int):
    """Local-attention decode against a rolling buffer [B, W, KV, hd] that
    holds position ``p`` at slot ``p % W``; HBM cost O(window), not
    O(max_len).  Returns (out, cache_k, cache_v), the row written in place."""
    w = cache_k.shape[1]
    q = _write_row(x, p, cfg, cache_k, cache_v, pos, pos % w)
    # true position held by slot j: the largest p' ≤ pos with p' % w == j
    # (``%`` on tensors is floor modulo, as jnp's)
    j = torch.arange(w, device=x.device)
    kpos = pos - ((pos - j) % w)
    valid = (kpos >= 0) & (kpos > pos - window)
    return _attend_cached(x, q, p, cfg, cache_k, cache_v, valid), cache_k, cache_v


def fill_windowed_cache(cache_k, cache_v, k, v):
    """Prefill a rolling buffer [B, W, KV, hd] from full-prompt K/V
    [B, Sp, KV, hd] in place: the last W positions, each at slot
    ``position % W``."""
    w = cache_k.shape[1]
    sp = k.shape[1]
    if sp <= w:
        write_positions(cache_k, 0, k)
        write_positions(cache_v, 0, v)
        return cache_k, cache_v
    positions = sp - w + torch.arange(w, device=k.device)
    slots = positions % w
    cache_k[:, slots] = k[:, positions].to(cache_k.dtype)
    cache_v[:, slots] = v[:, positions].to(cache_v.dtype)
    return cache_k, cache_v


def cross_attention_cached(x, p, cfg: ModelConfig, cross_k, cross_v) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (whisper).
    x [B,S,D]; cross_k/v [B,enc,KV,hd] in any dtype (cast to x's).  Scores
    in x's dtype, the softmax in float32, as the reference."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = shard_heads(x @ p["wq"].to(x.dtype), kvh).reshape(b, s, h, hd)
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cross_k.to(x.dtype)).to(torch.float32)
    scores = scores / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = shard_heads(torch.einsum("bkgqs,bskd->bqkgd", w, cross_v.to(x.dtype)), kvh)
    return shard_heads(out.reshape(b, s, h * hd), kvh) @ p["wo"].to(x.dtype)
