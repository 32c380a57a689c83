"""Top-K extraction over the [V, κ] rank matrix (counterpart of
``repro.ppr_serving.topk``; plain PyTorch — the reference uses XLA's
``lax.top_k`` here, not a Pallas kernel).

Two paths, identical results:

1. ``topk_dense``      one stable descending sort over each full column.
2. ``topk_streaming``  the column consumed in ``v_tile``-vertex tiles with an
                       O(k) running buffer per column, as a kernel fused into
                       the SpMV output stream would.

Both rank float32 scores or raw fixed-point states (int32 tensors of uint32
bits, widened to int64 so the order is the unsigned one).

Determinism: equal scores rank by ascending vertex id.  ``torch.topk`` does
not promise that, so ranking is a *stable* descending sort: equal keys keep
their vertex order, and in the streaming merge the running buffer (lower ids)
sits ahead of the current tile.

Self-exclusion: ``exclude`` removes one vertex per column by *deletion*, not
value-masking: ranking runs with a k+1 buffer and the excluded vertex is
dropped where present (masking to the domain minimum would let it re-enter
on zero-score ties).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.fixed_point import widen_u32, wrap_u32

Tensor = torch.Tensor


def _keys(P: Tensor) -> Tensor:
    """Rank keys [κ, V]: raw int32 bits widened to their uint32 values."""
    return (widen_u32(P) if P.dtype == torch.int32 else P).T


def _top(keys: Tensor, ids: Tensor, kk: int) -> Tuple[Tensor, Tensor]:
    """The kk largest keys per row, ties to the earlier column; (ids, keys)."""
    vals, order = torch.sort(keys, dim=1, descending=True, stable=True)
    return torch.gather(ids, 1, order[:, :kk]), vals[:, :kk]


def _drop_excluded(idx: Tensor, vals: Tensor, exclude: Tensor, k: int
                   ) -> Tuple[Tensor, Tensor]:
    """Remove the (at most one) excluded entry per row of a top-(k+1) result,
    preserving order, and truncate to k."""
    is_ex = (idx == exclude.to(idx.dtype)[:, None]).to(torch.int8)
    order = torch.sort(is_ex, dim=1, stable=True).indices[:, :k]
    return torch.gather(idx, 1, order), torch.gather(vals, 1, order)


def _finish(P: Tensor, idx: Tensor, keys: Tensor, exclude, k: int):
    vals = wrap_u32(keys) if P.dtype == torch.int32 else keys
    idx = idx.to(torch.int32)
    if exclude is None:
        return idx, vals
    return _drop_excluded(idx, vals, torch.as_tensor(exclude, device=P.device), k)


# repro: hot-path
def topk_dense(P: Tensor, k: int, exclude: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor]:
    """(vertices [κ, k] int32, scores [κ, k] in P's dtype) of the k highest
    per column, with ``exclude[j]`` (usually the query vertex) deleted from
    column j."""
    kk = k if exclude is None else k + 1
    v, kappa = P.shape
    if kk > v:
        raise ValueError(f"k={k} (+exclusion) exceeds num_vertices={v}")
    ids = torch.arange(v, device=P.device).expand(kappa, v)
    idx, keys = _top(_keys(P), ids, kk)
    return _finish(P, idx, keys, exclude, k)


# repro: hot-path
def topk_streaming(P: Tensor, k: int, v_tile: int = 1024,
                   exclude: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Streaming merge over vertex tiles; == ``topk_dense`` bit-for-bit.

    Requires v_tile ≥ k+1 (the running buffer is seeded from the first tile).
    """
    kk = k if exclude is None else k + 1
    if v_tile < kk:
        raise ValueError(f"v_tile={v_tile} must be >= k(+exclusion)={kk}")
    v, kappa = P.shape
    if kk > v:
        raise ValueError(f"k={k} (+exclusion) exceeds num_vertices={v}")
    keys = _keys(P)
    ids = torch.arange(v, device=P.device).expand(kappa, v)
    buf_i, buf_v = _top(keys[:, :v_tile], ids[:, :v_tile], kk)
    for base in range(v_tile, v, v_tile):
        cand_v = torch.cat([buf_v, keys[:, base:base + v_tile]], dim=1)
        cand_i = torch.cat([buf_i, ids[:, base:base + v_tile]], dim=1)
        buf_i, buf_v = _top(cand_v, cand_i, kk)
    return _finish(P, buf_i, buf_v, exclude, k)
