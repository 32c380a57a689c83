"""Top-K selection over the [V, κ] state — CUDA kernel and its plain version.

Replaces no TPU kernel: the reference ranks with XLA's ``lax.top_k``
(``src/repro/ppr_serving/topk.py``), and the port ranked with a stable
``torch.sort`` of every column, which is the plain version here.  The kernel
is ``csrc/topk_select.cu``: one launch that reads P once (its bound on the
H100: V·κ·4 bytes over 3.35 TB/s), keeps the best entries of each column in
a warp's registers and merges the CTAs' candidates in the last CTA to
finish.  A k above ``KMAX`` takes ceil(k / KMAX) such launches, each
selecting the next ``KMAX`` entries after the last one the launch before it
wrote.

Both rank float32 scores, or raw fixed-point states (int32 tensors of
uint32 bits) by their unsigned value; equal keys rank by ascending vertex
id; ``exclude[j]`` is deleted from column j.  ``topk_select`` runs the plain
version for CPU tensors and launches the kernel (or raises) for CUDA
tensors; ``topk_select.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.fixed_point import widen_u32, wrap_u32
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand
from repro_torch.kernels.fused_ppr import _sm_count

__all__ = ["KMAX", "RANKED_DTYPES", "rank_keys", "top_sorted", "finish_top",
           "topk_select_plain", "topk_select", "select_geometry"]

Tensor = torch.Tensor

_CU = _build.csrc_constants("topk_select.cu")
#: the most entries a launch selects a column
KMAX = _CU["kTopkMax"]
#: the state dtypes the kernel ranks
RANKED_DTYPES = (torch.int32, torch.float32)


def rank_keys(P: Tensor) -> Tensor:
    """Rank keys [κ, V]: raw int32 bits widened to their uint32 values."""
    return (widen_u32(P) if P.dtype == torch.int32 else P).T


def top_sorted(keys: Tensor, ids: Tensor, kk: int) -> Tuple[Tensor, Tensor]:
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


def finish_top(P: Tensor, idx: Tensor, keys: Tensor, exclude, k: int):
    """(ids int32, scores in P's dtype) of a top-kk by ``top_sorted``, the
    excluded vertex deleted where ``exclude`` is given."""
    vals = wrap_u32(keys) if P.dtype == torch.int32 else keys
    idx = idx.to(torch.int32)
    if exclude is None:
        return idx, vals
    return _drop_excluded(idx, vals, torch.as_tensor(exclude, device=P.device), k)


def topk_select_plain(P: Tensor, k: int, exclude=None) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch: one stable descending sort of
    every column, then the exclusion's deletion from the top k + 1."""
    v, kappa = P.shape
    kk = k if exclude is None else k + 1
    ids = torch.arange(v, device=P.device).expand(kappa, v)
    idx, keys = top_sorted(rank_keys(P), ids, kk)
    return finish_top(P, idx, keys, exclude, k)


def select_geometry(num_rows: int, kappa: int, sms: int) -> Tuple[int, int]:
    """(rows a tile, CTAs a column group) of the kernel over [num_rows, κ]:
    a tile is ``kPrefetch`` copy passes of one row per ``min(κ, kSelectWarps)``
    threads; the grid is ``kCtasPerSm`` CTAs an SM, or one a tile."""
    width = min(kappa, _CU["kSelectWarps"])
    tile_rows = _CU["kPrefetch"] * (32 * _CU["kSelectWarps"] // width)
    return tile_rows, max(1, min(-(-num_rows // tile_rows), _CU["kCtasPerSm"] * sms))


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_select_launch.argtypes = [vp, vp, i, i, i, i, i, i, vp, vp, vp, vp, i, vp]
    lib.topk_select_launch.restype = i
    lib.topk_select_error_string.argtypes = [i]
    lib.topk_select_error_string.restype = ctypes.c_char_p


def topk_select(P: Tensor, k: int, exclude: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """(vertices [κ, k] int32, scores [κ, k] in P's dtype) of the k highest
    entries of each column of ``P`` [V, κ], ``exclude[j]`` deleted from
    column j: ``topk_select_plain`` bit for bit.

    On the card ``P`` is a contiguous int32 (raw bits) or float32 tensor,
    ``exclude`` a tensor on its device (one vertex a column, or one for all),
    and 1 <= k, k (+1 with ``exclude``) <= V.  The call launches the kernel
    ceil(k / KMAX) times and neither synchronises nor copies to the host."""
    if P.device.type == "cpu":
        return topk_select_plain(P, k, exclude)
    if P.dtype not in RANKED_DTYPES:
        raise TypeError(f"P must be int32 raw bits or float32, got {P.dtype}")
    v, kappa = P.shape
    kk = k if exclude is None else k + 1
    if not 1 <= k or kk > v:
        raise ValueError(f"k={k} (+exclusion) must lie in [1, V={v}]")
    check_operand(P, "P", P.dtype, dims=2)
    ex = None
    if exclude is not None:
        ex = torch.broadcast_to(torch.as_tensor(exclude, device=P.device).to(torch.int32),
                                (kappa,)).contiguous()
    _, grid = select_geometry(v, kappa, _sm_count(P.device))
    groups = -(-kappa // _CU["kSelectWarps"])
    cand = torch.empty((2, kappa, grid, min(k, KMAX)), dtype=torch.int32, device=P.device)
    idx = torch.empty((kappa, k), dtype=torch.int32, device=P.device)
    vals = torch.empty((kappa, k), dtype=P.dtype, device=P.device)
    stream = torch.cuda.current_stream(P.device)
    tickets = _build.tickets("topk_select", P.device, stream, groups)
    lib = _build.load("topk_select", _declare)
    with torch.cuda.device(P.device):
        for offset in range(0, k, KMAX):
            status = lib.topk_select_launch(
                P.data_ptr(), None if ex is None else ex.data_ptr(), v, kappa,
                min(KMAX, k - offset), offset, k, grid, cand.data_ptr(), idx.data_ptr(),
                vals.data_ptr(), tickets.data_ptr(), int(P.dtype == torch.float32),
                stream.cuda_stream)
            if status:
                raise RuntimeError(f"topk_select launch failed: "
                                   f"{lib.topk_select_error_string(status).decode()}")
            topk_select.launches += 1
    return idx, vals


topk_select.launches = 0
