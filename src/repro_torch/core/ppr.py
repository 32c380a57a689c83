"""Batched Personalized PageRank (paper Alg. 1 / eq. 1) in float and fixed point.

Counterpart of ``repro.core.ppr``.

P_{t+1} = α·X·P_t + α/|V|·(d̄ᵀP_t)·1 + (1−α)·V̄       (eq. 1)

κ personalization vertices are batched as columns of P.  The fixed-point
variant reproduces the FPGA datapath bit-for-bit on raw int32 bits:
truncating multiplies, raw-domain sums that wrap mod 2^32, saturating adds.
The reference's ``lax.scan`` drivers become Python loops over the same
single-iteration bodies, so step-driven and looped results are identical.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.coo import COOGraph
from repro_torch.core.fixed_point import QFormat, widen_u32, wrap_u32
from repro_torch.core.spmv import (
    make_sharded_spmv,
    make_sharded_spmv_fixed,
    spmv_fixed,
    spmv_float,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PPRConfig:
    alpha: float = 0.85
    iterations: int = 10          # paper: 10 iterations suffice (§5.1)
    kappa: int = 8                # personalization vertices per pass (paper: 8–16)
    track_convergence: bool = True


def personalization_matrix(num_vertices: int, pers: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """V̄ of eq. (1): one-hot column per personalization vertex, [V, κ]."""
    k = pers.shape[0]
    V = torch.zeros((num_vertices, k), dtype=dtype, device=pers.device)
    V[pers.long(), torch.arange(k, device=pers.device)] = 1
    return V


def personalization_matrix_fixed(num_vertices: int, pers: torch.Tensor,
                                 fmt: QFormat) -> torch.Tensor:
    """V̄ in the raw domain (1.0 is exactly representable in Q1.f)."""
    k = pers.shape[0]
    V = torch.zeros((num_vertices, k), dtype=torch.int32, device=pers.device)
    V[pers.long(), torch.arange(k, device=pers.device)] = fmt.scale
    return V


# ----------------------------------------------------------------------------
# single-iteration bodies (shared by the loop drivers and the step API)
# ----------------------------------------------------------------------------
def _float_combine(xp, dangling_mass, Vmat, *, num_vertices: int, alpha: float):
    """eq. (1) elementwise combine, in the reference's operation order."""
    return alpha * xp + (alpha / num_vertices) * dangling_mass[None, :] \
        + (1.0 - alpha) * Vmat


def _float_iteration(x, y, val, d, Vmat, P, *, num_vertices: int, alpha: float):
    dangling_mass = d @ P                                        # [K]
    xp = spmv_float(x, y, val, P, num_vertices)
    return _float_combine(xp, dangling_mass, Vmat,
                          num_vertices=num_vertices, alpha=alpha)


def _fixed_consts(fmt: QFormat, num_vertices: int, alpha: float):
    """Datapath scalars encoded in the format — host float64 ``int(x·scale)``,
    the reference's formula exactly.  α/|V| underflows to 0 when
    1/|V| < 2^-f, as the real datapath would."""
    return (int(alpha * fmt.scale),
            int((1.0 - alpha) * fmt.scale),
            int(alpha / num_vertices * fmt.scale))


def _fixed_dangling_mass(d_raw: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Σ_{i dangling} P[i,k] — raw-domain sum mod 2^32, [K] int32 bits."""
    return wrap_u32((d_raw.to(torch.int64)[:, None] * widen_u32(P)).sum(0))


def _fixed_combine(xp, dangling_mass, Vmat, *, fmt: QFormat, alpha_raw,
                   one_minus_alpha_raw, alpha_over_v_raw):
    """eq. (1) combine in the raw domain — truncating multiplies, saturating
    adds, in the reference's nesting."""
    return fmt.add(
        fmt.add(fmt.mul(alpha_raw, xp),
                fmt.mul(alpha_over_v_raw, dangling_mass)[None, :]),
        fmt.mul(one_minus_alpha_raw, Vmat),
    )


def _fixed_iteration(x, y, val_raw, d_raw, Vmat, P, *, fmt: QFormat,
                     num_vertices: int, alpha_raw, one_minus_alpha_raw,
                     alpha_over_v_raw):
    dangling_mass = _fixed_dangling_mass(d_raw, P)
    xp = spmv_fixed(x, y, val_raw, P, num_vertices, fmt)
    return _fixed_combine(xp, dangling_mass, Vmat, fmt=fmt, alpha_raw=alpha_raw,
                          one_minus_alpha_raw=one_minus_alpha_raw,
                          alpha_over_v_raw=alpha_over_v_raw)


# ----------------------------------------------------------------------------
# step API — one eq. (1) iteration per call, for external drivers
# ----------------------------------------------------------------------------
# repro: hot-path
def ppr_step_float(x, y, val, dangling, Vmat, P, *, num_vertices: int,
                   alpha: float) -> torch.Tensor:
    """P_{t+1} from P_t, float32.  ``Vmat`` is the one-hot personalization matrix."""
    return _float_iteration(x, y, val, dangling.to(torch.float32), Vmat, P,
                            num_vertices=num_vertices, alpha=alpha)


@functools.lru_cache(maxsize=64)
def make_ppr_fixed_step(fmt: QFormat, num_vertices: int, alpha: float):
    """Bit-exact single iteration in the raw domain of ``fmt``."""
    a_raw, oma_raw, aov_raw = _fixed_consts(fmt, num_vertices, alpha)

    # repro: hot-path
    def step(x, y, val_raw, dangling, Vmat, P) -> torch.Tensor:
        return _fixed_iteration(
            x, y, val_raw, dangling, Vmat, P,
            fmt=fmt, num_vertices=num_vertices, alpha_raw=a_raw,
            one_minus_alpha_raw=oma_raw, alpha_over_v_raw=aov_raw)

    return step


# ----------------------------------------------------------------------------
# sharded step API — one eq. (1) iteration over a mesh-partitioned edge stream
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def make_ppr_sharded_float_step(mesh, axis: str, num_vertices: int, alpha: float):
    """float32 single iteration whose SpMV runs over the shards of ``mesh``
    along ``axis`` (``core.spmv.make_sharded_spmv``).

    ``step(shards, dangling, Vmat, P)`` takes one ``(StreamTopology,
    values)`` pair per shard and the rest on the controller.  Dangling mass
    and the eq. (1) combine run on the controller with the same operations
    as ``ppr_step_float`` (``_float_combine``), so the two steps can differ
    only by the per-shard SpMV's summation order.
    """
    spmv = make_sharded_spmv(mesh, axis, num_vertices)

    # repro: hot-path
    def step(shards, dangling, Vmat, P) -> torch.Tensor:
        dangling_mass = dangling.to(torch.float32) @ P
        xp = spmv(shards, P)
        return _float_combine(xp, dangling_mass, Vmat,
                              num_vertices=num_vertices, alpha=alpha)

    return step


@functools.lru_cache(maxsize=32)
def make_ppr_sharded_fixed_step(fmt: QFormat, mesh, axis: str,
                                num_vertices: int, alpha: float):
    """Bit-exact fixed-point single iteration over a mesh.

    Per-shard raw sums are exact and each dst row lives on exactly one
    shard, so the result is *bit-identical* to ``make_ppr_fixed_step``'s.
    """
    a_raw, oma_raw, aov_raw = _fixed_consts(fmt, num_vertices, alpha)
    spmv = make_sharded_spmv_fixed(mesh, axis, num_vertices, fmt)

    # repro: hot-path
    def step(shards, dangling, Vmat, P) -> torch.Tensor:
        dangling_mass = _fixed_dangling_mass(dangling, P)
        xp = spmv(shards, P)
        return _fixed_combine(xp, dangling_mass, Vmat, fmt=fmt, alpha_raw=a_raw,
                              one_minus_alpha_raw=oma_raw, alpha_over_v_raw=aov_raw)

    return step


# ----------------------------------------------------------------------------
# loop drivers
# ----------------------------------------------------------------------------
# repro: hot-path
def ppr_float(x, y, val, dangling, pers, *, num_vertices: int, iterations: int,
              alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (P [V,K] float32, deltas [iterations] convergence trace)."""
    V = personalization_matrix(num_vertices, pers)
    d = dangling.to(torch.float32)
    P, deltas = V, []
    for _ in range(iterations):
        Pn = _float_iteration(x, y, val, d, V, P,
                              num_vertices=num_vertices, alpha=alpha)
        deltas.append(torch.linalg.vector_norm(Pn - P, dim=0).max())
        P = Pn
    return P, torch.stack(deltas) if deltas else torch.zeros(0, device=V.device)


@functools.lru_cache(maxsize=64)
def make_ppr_fixed(fmt: QFormat, num_vertices: int, iterations: int, alpha: float):
    """Bit-exact fixed-point PPR for one Q format."""
    a_raw, oma_raw, aov_raw = _fixed_consts(fmt, num_vertices, alpha)

    # repro: hot-path
    def run(x, y, val_raw, dangling, pers):
        Vmat = personalization_matrix_fixed(num_vertices, pers, fmt)
        P, deltas = Vmat, []
        for _ in range(iterations):
            Pn = _fixed_iteration(
                x, y, val_raw, dangling, Vmat, P,
                fmt=fmt, num_vertices=num_vertices, alpha_raw=a_raw,
                one_minus_alpha_raw=oma_raw, alpha_over_v_raw=aov_raw)
            delta = torch.abs(widen_u32(Pn).to(torch.float32)
                              - widen_u32(P).to(torch.float32))
            deltas.append(torch.sqrt((delta * delta).sum(0)).max() / fmt.scale)
            P = Pn
        return P, (torch.stack(deltas) if deltas
                   else torch.zeros(0, device=Vmat.device))

    return run


# ----------------------------------------------------------------------------
# convenience drivers
# ----------------------------------------------------------------------------
def run_ppr(
    g: COOGraph,
    personalization: np.ndarray,
    cfg: PPRConfig = PPRConfig(),
    fmt: Optional[QFormat] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Run PPR on a host graph.  fmt=None → float32; else bit-exact Qm.f.

    Returns (scores [V,K] numpy — float32, or float64 dequantized raw for
    fixed point — and the convergence deltas [iters]).
    """
    dev = resolve_device(device)
    pers = torch.as_tensor(np.atleast_1d(personalization).astype(np.int64),
                           device=dev)
    x = torch.as_tensor(g.x, device=dev)
    y = torch.as_tensor(g.y, device=dev)
    dang = torch.as_tensor(g.dangling, device=dev)
    if fmt is None:
        P, deltas = ppr_float(
            x, y, torch.as_tensor(g.val, device=dev), dang, pers,
            num_vertices=g.num_vertices, iterations=cfg.iterations, alpha=cfg.alpha)
        return P.cpu().numpy(), deltas.cpu().numpy()
    run = make_ppr_fixed(fmt, g.num_vertices, cfg.iterations, cfg.alpha)
    val_raw = torch.as_tensor(g.quantized_val(fmt).view(np.int32), device=dev)
    P_raw, deltas = run(x, y, val_raw, dang, pers)
    raw = P_raw.cpu().numpy().view(np.uint32)
    return raw.astype(np.float64) / fmt.scale, deltas.cpu().numpy()


def batched_ppr(
    g: COOGraph,
    all_vertices: np.ndarray,
    cfg: PPRConfig = PPRConfig(),
    fmt: Optional[QFormat] = None,
    device="cuda",
) -> np.ndarray:
    """Process many personalization requests in κ-sized batches (paper §5.1)."""
    out = np.zeros((g.num_vertices, len(all_vertices)))
    for i in range(0, len(all_vertices), cfg.kappa):
        batch = np.asarray(all_vertices[i: i + cfg.kappa])
        pad = cfg.kappa - batch.shape[0]
        padded = np.concatenate([batch, np.zeros(pad, np.int64)]) if pad else batch
        scores, _ = run_ppr(g, padded, cfg, fmt, device=device)
        out[:, i: i + batch.shape[0]] = scores[:, : batch.shape[0]]
    return out
