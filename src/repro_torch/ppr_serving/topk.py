"""Top-K extraction over the [V, κ] rank matrix (counterpart of
``repro.ppr_serving.topk``; the reference uses XLA's ``lax.top_k`` here, not
a Pallas kernel).

Two paths, identical results:

1. ``topk_dense``      every full column ranked at once: on the card by the
                       selection kernel of ``kernels/topk_select.py`` (one
                       pass over P), elsewhere by its plain version, one
                       stable descending sort of each column.
2. ``topk_streaming``  the column consumed in ``v_tile``-vertex tiles with an
                       O(k) running buffer per column, as a kernel fused into
                       the SpMV output stream would.

Both rank float32 scores or raw fixed-point states (int32 tensors of uint32
bits, ranked by their unsigned value).

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

from repro_torch.kernels.topk_select import finish_top, rank_keys, top_sorted, topk_select

Tensor = torch.Tensor


# repro: hot-path
def topk_dense(P: Tensor, k: int, exclude: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor]:
    """(vertices [κ, k] int32, scores [κ, k] in P's dtype) of the k highest
    per column, with ``exclude[j]`` (usually the query vertex) deleted from
    column j.

    A CUDA ``P`` goes through the selection kernel (int32 raw bits or
    float32, 1 <= k; it raises on anything else), a CPU ``P`` through its
    plain version."""
    kk = k if exclude is None else k + 1
    v, kappa = P.shape
    if kk > v:
        raise ValueError(f"k={k} (+exclusion) exceeds num_vertices={v}")
    return topk_select(P.contiguous(), k, exclude)


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
    keys = rank_keys(P)
    ids = torch.arange(v, device=P.device).expand(kappa, v)
    buf_i, buf_v = top_sorted(keys[:, :v_tile], ids[:, :v_tile], kk)
    for base in range(v_tile, v, v_tile):
        cand_v = torch.cat([buf_v, keys[:, base:base + v_tile]], dim=1)
        cand_i = torch.cat([buf_i, ids[:, base:base + v_tile]], dim=1)
        buf_i, buf_v = top_sorted(cand_v, cand_i, kk)
    return finish_top(P, buf_i, buf_v, exclude, k)
