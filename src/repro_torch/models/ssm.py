"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) layer (counterpart of
``repro.models.ssm``).

Chunked SSD: the sequence is split into chunks; within a chunk the
recurrence runs in its dual quadratic-attention form, and the chunk-boundary
states pass through a loop over chunks (the reference's ``lax.scan``) —
O(S·chunk) compute, O(1) recurrent state.  Decode keeps (conv buffer, SSD
state) and is an O(1) state update.

As in the reference, ``ssd_chunked`` needs the sequence to be a whole number
of chunks, and ``mamba_layer`` takes ``chunk = min(256, S)``: a prompt longer
than 256 tokens that is not a multiple of 256 raises ``TypeError`` there and
here.  ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` (no
threshold).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import batch_axes, constrain, local_region, model_if_divides
from repro_torch.models.common import dense_init, rmsnorm

__all__ = ["NGROUPS", "Mamba", "init_mamba", "ssd_chunked", "mamba_layer",
           "mamba_layer_with_state", "mamba_init_cache", "mamba_decode_step"]

NGROUPS = 1  # B/C projection groups (mamba2 default 1 for these sizes)


class Mamba(nn.ParameterDict):
    """w_in [D, 2·di + 2·g·st + nh] (→ z, x, B, C, dt), conv_w [K, conv_dim],
    conv_b, A_log, D, dt_bias [nh], norm_w [di], w_out [di, D]; float32
    masters, the reference's initial values (A_log 0, D 1, dt_bias 0)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device=None):
        d, di, st, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * NGROUPS * st
        p = {
            "w_in": dense_init((d, 2 * di + 2 * NGROUPS * st + nh), d, generator, device),
            "conv_w": dense_init((cfg.ssm_conv, conv_dim), cfg.ssm_conv, generator, device),
            "conv_b": torch.zeros((conv_dim,), device=device),
            "A_log": torch.zeros((nh,), device=device),
            "D": torch.ones((nh,), device=device),
            "dt_bias": torch.zeros((nh,), device=device),
            "norm_w": torch.ones((di,), device=device),
            "w_out": dense_init((di, d), di, generator, device),
        }
        super().__init__({k: nn.Parameter(t, requires_grad=False) for k, t in p.items()})


def init_mamba(cfg: ModelConfig, generator: Optional[torch.Generator], device=None) -> Mamba:
    return Mamba(cfg, generator, device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(xz: torch.Tensor, cfg: ModelConfig):
    """in_proj output → (z, x, B, C, dt); split at indices, as ``jnp.split``.
    Under a sharding context the output, whose columns the model axis
    shards without regard to the pieces, is gathered once first."""
    di, st = cfg.ssm_d_inner, cfg.ssm_state
    xz = constrain(xz, (batch_axes(xz.shape[0]),))
    return torch.tensor_split(
        xz, [di, 2 * di, 2 * di + NGROUPS * st, 2 * di + 2 * NGROUPS * st], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x [B,S,C], w [K,C] → [B,S,C]."""
    k = w.shape[0]
    # K-1 zero rows before the sequence (a cat: DTensor's pad rule in torch
    # 2.11 drops a mesh dim from the result's placements)
    xp = torch.cat([torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                device=x.device), x], dim=1)
    # Σ_j x[t-k+1+j] w[j], summed in the reference's order
    out = sum(xp[:, j: j + x.shape[1], :] * w[j][None, None, :] for j in range(k))
    return out + b[None, None, :]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: L[i,j] = Σ_{j<m≤i} x[m] (−inf above the diagonal),
    each summed directly, as the Mamba2 repo's ``segsum``.  The reference's
    ``cs[i] − cs[j]`` cancels: at |cs| ~ 200 (a chunk of 256 decays) its
    entries near the diagonal carry ~1e-5 of absolute error."""
    t = x.shape[-1]
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), -1)
    xr = x[..., None].expand(*x.shape, t).masked_fill(~keep, 0.0)   # xr[..., m, j] = x[m], m > j
    ss = torch.cumsum(xr, dim=-2)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return ss.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward.  x [b,s,h,p], dt [b,s,h] (post-softplus), A [h] (negative),
    B,C [b,s,g,n].  Returns y [b,s,h,p] and the final state [b,h,p,n]."""
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    if s % chunk:
        raise TypeError(f"ssd_chunked: a sequence of {s} is not a whole number of "
                        f"chunks of {chunk} (the reference's reshape into "
                        f"{s // chunk} chunks fails the same way)")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)
    dA = (dtc * A[None, None, None, :]).permute(0, 1, 3, 2)    # [b,nc,h,l]
    dA_cs = torch.cumsum(dA, dim=-1)
    # 1. intra-chunk (diagonal blocks): quadratic within the chunk
    L = torch.exp(_segsum(dA))                                 # [b,nc,h,l,l]
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)            # [b,nc,g,l,l]
    CBh = torch.repeat_interleave(CB, h // g, dim=2)           # [b,nc,h,l,l]
    xdt = xc * dtc[..., None]                                  # [b,nc,l,h,p]
    y_diag = torch.einsum("bchls,bcshp->bclhp", CBh * L, xdt)
    # 2. chunk-boundary states; decay Σ_{l<m<chunk} dA[m] summed directly
    # (the reference's dA_cs[-1] − dA_cs cancels as _segsum's does)
    rest = torch.cumsum(dA.flip(-1), dim=-1).flip(-1)          # Σ_{m≥l}
    decay_states = torch.exp(torch.cat([rest[..., 1:], torch.zeros_like(rest[..., :1])], -1))
    states = torch.einsum("bclgn,bchl,bclhp->bchpn", Bc, decay_states, xdt)
    # 3. inter-chunk recurrence, one step a chunk (the state BEFORE each chunk)
    chunk_decay = torch.exp(dA_cs[..., -1])                    # [b,nc,h]
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [b,nc,h,p,n]
    # 4. inter-chunk contribution to the outputs
    state_decay = torch.exp(dA_cs)                             # [b,nc,h,l]
    y_off = torch.einsum("bclgn,bchpn,bchl->bclhp", Cc, prev_states, state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), state


def mamba_layer_with_state(x: torch.Tensor, p, cfg: ModelConfig, chunk: int = 256
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full mamba2 block (in_proj → conv → SSD → gate·norm → out_proj), and
    the decode cache entry it leaves: the last K−1 conv inputs (float32) and
    the final SSD state."""
    b, s, _ = x.shape
    di, st, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, B, C, dt = _split_proj(x @ p["w_in"].to(x.dtype), cfg)
    conv_in = torch.cat([xi, B, C], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    # channels sharded without regard to the pieces: gathered once (no-op unset)
    conv_out = constrain(conv_out, (batch_axes(b),))
    xi, B, C = torch.tensor_split(conv_out, [di, di + NGROUPS * st], dim=-1)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].to(torch.float32))
    xh = xi.reshape(b, s, nh, hd).to(torch.float32)
    # the scan is each device's own program under a sharding context: its
    # batch rows, its heads where they divide the model axis, the whole
    # sequence (the chunk loop, and cumsum's backward flip, which DTensor in
    # torch 2.11 has no rule for).  A is whole over the batch devices, B and
    # C over the model devices: each device holds its rows' or its heads'
    # part of their gradients
    dp, hm = batch_axes(b), model_if_divides(nh)
    scan = local_region(ssd_chunked,
                        ((dp, None, hm), (dp, None, hm), (hm,), (dp,), (dp,), None),
                        [(dp, None, hm), (dp, hm)], partial_grads={2: dp, 3: hm, 4: hm})
    y, final = scan(xh, dt, A,
                    B.reshape(b, s, NGROUPS, st).to(torch.float32),
                    C.reshape(b, s, NGROUPS, st).to(torch.float32),
                    min(chunk, s))
    y = y + xh * p["D"][None, None, :, None]
    y = rmsnorm(y.reshape(b, s, di).to(x.dtype) * F.silu(z), p["norm_w"])
    tail = conv_in[:, -(cfg.ssm_conv - 1):, :].to(torch.float32)
    return y @ p["w_out"].to(x.dtype), {"conv": tail, "ssd": final}


def mamba_layer(x: torch.Tensor, p, cfg: ModelConfig, chunk: int = 256) -> torch.Tensor:
    """Full mamba2 block: x [B,S,D] → [B,S,D]."""
    return mamba_layer_with_state(x, p, cfg, chunk)[0]


# ---------------------------------------------------------------------------
# decode (O(1) state update)
# ---------------------------------------------------------------------------
def mamba_init_cache(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """One layer's decode cache, float32 whatever the activations' dtype (as
    the reference's ``init_cache`` builds it)."""
    di, st, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_dim = di + 2 * NGROUPS * st
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), device=device),
            "ssd": torch.zeros((batch, nh, hd, st), device=device)}


def mamba_decode_step(x: torch.Tensor, p, cfg: ModelConfig, cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, 1, D] → (y [B, 1, D], new cache).  The conv window is promoted
    to the cache's float32, as ``jnp.concatenate`` promotes it."""
    b = x.shape[0]
    di, st, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, B, C, dt = _split_proj(x[:, 0] @ p["w_in"].to(x.dtype), cfg)
    conv_in = torch.cat([xi, B, C], dim=-1)                                  # [B, conv_dim]
    window = torch.cat([cache["conv"], conv_in[:, None, :].to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(x.dtype)
    conv_out = F.silu((window * w[None]).sum(1) + p["conv_b"].to(x.dtype))
    conv_out = constrain(conv_out, (batch_axes(b),))      # gathered once, as above
    xi, B, C = torch.tensor_split(conv_out, [di, di + NGROUPS * st], dim=-1)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, :])             # [B,nh]
    A = -torch.exp(p["A_log"].to(torch.float32))
    xh = xi.reshape(b, nh, hd).to(torch.float32)
    hpg = nh // NGROUPS
    Bh = torch.repeat_interleave(B.reshape(b, NGROUPS, st).to(torch.float32), hpg, dim=1)
    Ch = torch.repeat_interleave(C.reshape(b, NGROUPS, st).to(torch.float32), hpg, dim=1)
    # under a sharding context the recurrence runs on each device's heads,
    # where the cache's state lies
    heads = (batch_axes(b), model_if_divides(nh))
    xh, dt, Bh, Ch = (constrain(t, heads) for t in (xh, dt, Bh, Ch))
    decay = torch.exp(dt * A[None, :])                                       # [B,nh]
    state = (cache["ssd"] * decay[..., None, None]
             + (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])          # [B,nh,hd,st]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xh * p["D"][None, :, None]
    y = rmsnorm(y.reshape(b, di).to(x.dtype) * F.silu(z), p["norm_w"])
    out = (y @ p["w_out"].to(x.dtype))[:, None, :]
    return out, {"conv": window[:, 1:], "ssd": state}
