"""Fused PPR iteration: SpMV + eq. (1) combine + dangling fold + residual.

Replaces ``src/repro/kernels/fused_ppr.py::fused_ppr_iteration`` (bodies
``_kernel_float_fused``/``_kernel_fixed_fused``).  One call computes

    P_{t+1} = α·X·P_t + α/|V|·(d̄ᵀP_t)·1 + (1−α)·V̄        (eq. 1)

and the per-column (L1, ∞, Σd²) of |P_{t+1} − P_t| that drives early exit.
The kernels are ``csrc/fused_ppr.cu`` over ``csrc/dst_stream.cuh``; they read
the pad-free dst stream of ``kernels/dst_stream.py``, built from this
module's ``FusedLayout`` through ``fused_schedule``.

Bound on the H100: memory bytes — 4 + 4 B per edge (col, val), ``row_ptr``,
P and V̄ read once, P_next written once.  The Pallas grid ran its dangling-
mass prologue before the stream; CUDA CTAs run concurrently, so an iteration
is two launches and no memset: (A) the edge-balanced SpMV (one warp a slice
of the stream) whose CTAs also fold dangling-mass partials, the last CTA
summing them; (B) a row-parallel pass that closes rows cut by a slice
boundary, applies the combine, writes P_next and folds the residual, its
last CTA summing the partials.  Every sum runs in a fixed order.

Host layout (``FusedLayout``, ``build_fused_layout`` with ``reuse``/``dirty``,
``quantize_layout_rows``, ``assemble_value_rows``) is the reference's,
copied, and stays array-equal to it.  The reference's ``default_interpret``
has no counterpart: the tensors' device decides.  ``fused_schedule`` derives
the per-dst-block packet-row ranges from the layout's step schedule.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernels (or raises) for CUDA tensors; ``<wrapper>.launches`` counts calls
that launched.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coo import COOGraph, quantize_values
from repro_torch.core.fixed_point import QFormat, widen_u32, wrap_u32
from repro_torch.core.ppr import _fixed_combine, _fixed_consts, _float_combine
from repro_torch.core.spmv import spmv_fixed, spmv_float
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand
from repro_torch.kernels.coo_spmv import (WARPS_PER_CTA, check_stream, launch_geometry,
                                          stream_rows)

__all__ = [
    "FusedLayout", "build_fused_layout", "quantize_layout_rows",
    "assemble_value_rows", "fused_schedule", "fused_ppr_iteration",
    "fused_ppr_plain", "dangling_mass", "dangling_mass_plain",
]


# ---------------------------------------------------------------------------
# host-side layout: dst-major packetized edge stream + per-step schedule
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FusedLayout:
    """Packetized dst-major edge layout + the kernel's per-step schedule.

    Per dst block ``d`` the edges are grouped by source block and padded to
    whole packets (``row_*[d]``: [p_d, packet] with local indices; pad entries
    are zero-valued self-edges to local vertex 0 — they contribute nothing).
    The assembled arrays carry one extra all-zero sentinel row at index
    ``num_rows - 1``, addressed by prologue steps and by the sentinel step of
    every empty dst block.

    The rebuild is per-dst-block and deterministic, so an incremental rebuild
    of only the dirty blocks is array-equal to a fresh build of the merged
    graph (tested) — the ``on_delta`` contract of the fused engine family.
    """
    num_vertices: int
    num_edges: int
    v_tile: int
    packet: int
    n_blk: int
    row_x: List[np.ndarray]      # per dst block: [p_d, packet] int32 local dst
    row_y: List[np.ndarray]      # per dst block: [p_d, packet] int32 local src
    row_val: List[np.ndarray]    # per dst block: [p_d, packet] f64 edge values
    x2: np.ndarray               # [num_rows, packet] int32 (+ sentinel row)
    y2: np.ndarray               # [num_rows, packet] int32
    val2: np.ndarray             # [num_rows, packet] f32
    step_row: np.ndarray         # [num_steps] int32  step → edge row
    step_dst: np.ndarray         # [num_steps] int32  step → dst block
    step_src: np.ndarray         # [num_steps] int32  step → src block
    step_first: np.ndarray       # [num_steps] int32  1 = zero the dst block
    step_last: np.ndarray        # [num_steps] int32  1 = combine + residual

    @property
    def n_prologue(self) -> int:
        return self.n_blk

    @property
    def num_steps(self) -> int:
        return int(self.step_row.shape[0])

    @property
    def num_rows(self) -> int:
        return int(self.x2.shape[0])


def _build_dst_row(x, y, val, v_tile: int, packet: int, n_blk: int):
    """One dst block's edges, grouped by src block, packet-padded, localized."""
    src_blk = (np.asarray(y, np.int64) // v_tile)
    order = np.argsort(src_blk, kind="stable")   # keep (dst, src) order inside
    xs = np.asarray(x, np.int64)[order]
    ys = np.asarray(y, np.int64)[order]
    vs = np.asarray(val)[order]
    sbs = src_blk[order]
    counts = np.bincount(sbs, minlength=n_blk).astype(np.int64)
    pad_counts = (counts + packet - 1) // packet * packet
    total = int(pad_counts.sum())
    row_x = np.zeros(total, np.int32)
    row_y = np.zeros(total, np.int32)
    row_val = np.zeros(total, np.float64)
    src_off = np.zeros(n_blk + 1, np.int64)
    np.cumsum(counts, out=src_off[1:])
    dst_off = np.zeros(n_blk + 1, np.int64)
    np.cumsum(pad_counts, out=dst_off[1:])
    for b in np.nonzero(counts)[0]:
        s0, s1 = src_off[b], src_off[b + 1]
        d0 = dst_off[b]
        n = s1 - s0
        row_x[d0:d0 + n] = xs[s0:s1] % v_tile
        row_y[d0:d0 + n] = ys[s0:s1] % v_tile
        row_val[d0:d0 + n] = vs[s0:s1]
    p_d = total // packet
    row_src = np.repeat(np.arange(n_blk, dtype=np.int32),
                        (pad_counts // packet))
    return (row_x.reshape(p_d, packet), row_y.reshape(p_d, packet),
            row_val.reshape(p_d, packet), row_src)


def _assemble_rows(rows: Sequence[np.ndarray], packet: int, dtype) -> np.ndarray:
    """Stack per-block rows and append the shared all-zero sentinel row."""
    parts = [np.asarray(r, dtype) for r in rows if r.shape[0]]
    parts.append(np.zeros((1, packet), dtype))
    return np.concatenate(parts, axis=0)


def assemble_value_rows(rows: Sequence[np.ndarray], packet: int,
                        dtype=np.uint32) -> np.ndarray:
    """Assemble per-block *value* rows (e.g. per-format raw uint32) into the
    kernel's [num_rows, packet] operand, sentinel row included."""
    return _assemble_rows(rows, packet, dtype)


def build_fused_layout(g: COOGraph, v_tile: int, packet: int,
                       reuse: Optional[FusedLayout] = None,
                       dirty=None) -> FusedLayout:
    """Packetize ``g``'s (unpadded, (dst, src)-lexsorted) edge stream.

    ``reuse``/``dirty``: incremental re-packetization — per-block rows of
    clean dst blocks are taken from ``reuse`` (same arrays, not copies), only
    blocks in ``dirty`` are rebuilt.  Requires an unchanged block count;
    callers fall back to a full rebuild when ``n_blk`` moves.  A clean
    block's rows keep their src blocks (read from ``reuse``'s schedule), so
    the result is array-equal to a fresh build of the merged graph; the
    reference gives them the dst block instead
    (``src/repro/kernels/fused_ppr.py:190``, ``ROADMAP.md`` §3).
    """
    v = g.num_vertices
    n_blk = max(1, -(-v // v_tile))
    if reuse is not None and (reuse.n_blk != n_blk or reuse.v_tile != v_tile
                              or reuse.packet != packet):
        raise ValueError("fused layout reuse requires identical block geometry")
    dirty_set = (set(range(n_blk)) if reuse is None or dirty is None
                 else {int(d) for d in dirty})
    # dst-major lexsorted stream ⇒ each dst block is one contiguous slice
    bounds = np.searchsorted(np.asarray(g.x), np.arange(n_blk + 1) * v_tile)
    if reuse is not None:
        reuse_off, reuse_src = fused_schedule(reuse)
    rows_x, rows_y, rows_v, rows_s = [], [], [], []
    for d in range(n_blk):
        if reuse is not None and d not in dirty_set:
            rx, ry, rv = reuse.row_x[d], reuse.row_y[d], reuse.row_val[d]
            rs = reuse_src[reuse_off[d]:reuse_off[d + 1]]
        else:
            a, b = int(bounds[d]), int(bounds[d + 1])
            rx, ry, rv, rsrc = _build_dst_row(
                g.x[a:b], g.y[a:b], g.val[a:b], v_tile, packet, n_blk)
            rs = rsrc
        rows_x.append(rx)
        rows_y.append(ry)
        rows_v.append(rv)
        rows_s.append(rs)
    x2 = _assemble_rows(rows_x, packet, np.int32)
    y2 = _assemble_rows(rows_y, packet, np.int32)
    val2 = _assemble_rows(rows_v, packet, np.float32)
    sentinel = x2.shape[0] - 1
    # schedule: prologue folds dangling block b into dm; then the dst-major
    # stream, with one sentinel step per empty dst block
    srow = [sentinel] * n_blk
    sdst = [0] * n_blk
    ssrc = list(range(n_blk))
    sfirst = [0] * n_blk
    slast = [0] * n_blk
    base = 0
    for d in range(n_blk):
        p_d = rows_x[d].shape[0]
        if p_d == 0:
            srow.append(sentinel)
            sdst.append(d)
            ssrc.append(0)
            sfirst.append(1)
            slast.append(1)
            continue
        for j in range(p_d):
            srow.append(base + j)
            sdst.append(d)
            ssrc.append(int(rows_s[d][j]))
            sfirst.append(1 if j == 0 else 0)
            slast.append(1 if j == p_d - 1 else 0)
        base += p_d
    return FusedLayout(
        num_vertices=v, num_edges=int(g.num_edges), v_tile=v_tile,
        packet=packet, n_blk=n_blk,
        row_x=rows_x, row_y=rows_y, row_val=rows_v,
        x2=x2, y2=y2, val2=val2,
        step_row=np.asarray(srow, np.int32),
        step_dst=np.asarray(sdst, np.int32),
        step_src=np.asarray(ssrc, np.int32),
        step_first=np.asarray(sfirst, np.int32),
        step_last=np.asarray(slast, np.int32))


def quantize_layout_rows(layout: FusedLayout, fmt: QFormat,
                         reuse_rows: Optional[List[np.ndarray]] = None,
                         dirty=None) -> List[np.ndarray]:
    """Per-dst-block raw uint32 value rows for ``fmt``.

    The quantizer is per-edge and order-independent, so requantizing only the
    dirty blocks (reusing the rest) equals a from-scratch quantization of the
    merged stream bit-for-bit.  Pad entries quantize 0.0 → raw 0.
    """
    dirty_set = (set(range(layout.n_blk)) if reuse_rows is None or dirty is None
                 else {int(d) for d in dirty})
    rows = []
    for d in range(layout.n_blk):
        if reuse_rows is not None and d not in dirty_set:
            rows.append(reuse_rows[d])
        else:
            rv = layout.row_val[d]
            rows.append(quantize_values(rv.ravel(), fmt).reshape(rv.shape))
    return rows


def fused_schedule(layout: FusedLayout):
    """(row_off [n_blk+1] int32, row_src [num_rows-1] int32) of the packet rows.

    Dst block d owns packet rows [row_off[d], row_off[d+1]); an empty block
    owns none (its sentinel step reads the all-zero row, which contributes
    nothing).  Derived from the step schedule: stream steps are the ones after
    the prologue, and real rows are every row but the trailing sentinel."""
    sentinel = layout.num_rows - 1
    stream = slice(layout.n_prologue, None)
    real = layout.step_row[stream] != sentinel
    dst = layout.step_dst[stream][real]
    row_off = np.zeros(layout.n_blk + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=layout.n_blk), out=row_off[1:])
    row_src = layout.step_src[stream][real].astype(np.int32)
    return row_off.astype(np.int32), row_src


# ---------------------------------------------------------------------------
# device scratch shared by the launches
# ---------------------------------------------------------------------------
# kernel B's CTA, as csrc/fused_ppr.cu is compiled with
COMBINE_THREADS = _build.csrc_constants("fused_ppr.cu")["kCombineThreads"]


def _tickets(device: torch.device, stream) -> torch.Tensor:
    """The words the kernels' last-CTA folds count arrivals on: [0] kernel
    A's dangling mass, [1] kernel B's residual, [2] the standalone dangling
    mass (``_build.tickets``: zero between launches)."""
    return _build.tickets("fused_ppr", device, stream, 3)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dangling_split(n_dang: int, max_parts: int):
    """(rows a CTA, CTAs) folding ``n_dang`` dangling rows into partials: at
    least 256 rows a CTA, so that few CTAs meet at the last-CTA fold."""
    per_cta = max(256, -(-n_dang // max(1, max_parts)))
    return per_cta, max(1, -(-n_dang // per_cta))


# ---------------------------------------------------------------------------
# (a) dangling mass
# ---------------------------------------------------------------------------
def dangling_mass_plain(p: torch.Tensor, dang_idx: torch.Tensor, *,
                        fixed: bool) -> torch.Tensor:
    """dm[k] = Σ_{i in dang_idx} P[i, k]: float32, or raw bits summed mod 2^32."""
    rows = p[dang_idx.long()]
    if fixed:
        return wrap_u32(widen_u32(rows).sum(0))
    return rows.sum(0)


def dangling_mass(p: torch.Tensor, dang_idx: torch.Tensor, *,
                  fixed: bool) -> torch.Tensor:
    """[K] dangling mass of ``p`` [V, K] over the int32 vertex list ``dang_idx``.

    On the card this is kernel A's dangling fold alone, in one launch: CTAs
    fold slices of ``dang_idx`` into partials, the last CTA sums them in a
    fixed order.  The fused iteration runs the same code inside kernel A."""
    if p.device.type == "cpu":
        return dangling_mass_plain(p, dang_idx, fixed=fixed)
    dom = torch.int32 if fixed else torch.float32
    check_operand(p, "p", dom, dims=2)
    check_operand(dang_idx, "dang_idx", torch.int32, dims=1)
    k = int(p.shape[1])
    launch_geometry(k, 32)
    n_dang = int(dang_idx.shape[0])
    per_cta, n_part = _dangling_split(n_dang, 4 * _sm_count(p.device))
    dm = torch.empty(k, dtype=p.dtype, device=p.device)
    dm_part = torch.empty((n_part, k), dtype=p.dtype, device=p.device)
    stream = torch.cuda.current_stream(p.device)
    tickets = _tickets(p.device, stream)
    lib = _build.load("fused_ppr", _declare)
    with torch.cuda.device(p.device):
        status = lib.dangling_mass_launch(
            p.data_ptr(), dang_idx.data_ptr(), n_dang, per_cta, n_part, k, int(fixed),
            dm_part.data_ptr(), dm.data_ptr(), tickets[2:].data_ptr(), stream.cuda_stream)
    _raise_on(lib, status, "dangling_mass")
    dangling_mass.launches += 1
    return dm


dangling_mass.launches = 0


# ---------------------------------------------------------------------------
# (b) the fused iteration
# ---------------------------------------------------------------------------
def _combine_consts(fmt: Optional[QFormat], num_vertices: int, alpha: float):
    """The kernel's (a_raw, aov_raw, oma_raw, max_raw, alpha_f, aov_f, oma_f):
    the fixed constants are ``_fixed_consts``; the float ones are computed in
    float64 on the host and passed as f32, like the reference's.  The other
    domain's slots are 0."""
    if fmt is None:
        return (0, 0, 0, 0, float(np.float32(alpha)),
                float(np.float32(alpha / num_vertices)), float(np.float32(1.0 - alpha)))
    a_raw, oma_raw, aov_raw = _fixed_consts(fmt, num_vertices, alpha)
    return (a_raw, aov_raw, oma_raw, fmt.max_raw, 0.0, 0.0, 0.0)


def fused_ppr_plain(topo, val, dang_idx, vmat, p, *, alpha: float,
                    fmt: Optional[QFormat] = None):
    """The fused iteration in plain PyTorch: ``(P_next [V,K], res [3,K] f32)``."""
    rows, v = stream_rows(topo.row_ptr), topo.num_rows
    dm = dangling_mass_plain(p, dang_idx, fixed=fmt is not None)
    if fmt is None:
        xp = spmv_float(rows, topo.col, val, p, v)
        pn = _float_combine(xp, dm, vmat, num_vertices=v, alpha=alpha)
        diff = torch.abs(pn - p)
    else:
        a_raw, oma_raw, aov_raw = _fixed_consts(fmt, v, alpha)
        xp = spmv_fixed(rows, topo.col, val, p, v, fmt)
        pn = _fixed_combine(xp, dm, vmat, fmt=fmt, alpha_raw=a_raw,
                            one_minus_alpha_raw=oma_raw, alpha_over_v_raw=aov_raw)
        diff = torch.abs(widen_u32(pn) - widen_u32(p)).to(torch.float32)
    res = torch.stack([diff.sum(0), diff.amax(0), (diff * diff).sum(0)])
    return pn, res


def fused_ppr_iteration(topo, val, dang_idx, vmat, p, *, alpha: float,
                        fmt: Optional[QFormat] = None):
    """One full eq. (1) iteration: ``(P_next [V, K], res [3, K] float32)``.

    ``topo`` is the ``StreamTopology`` of a ``DstStream`` over |V| rows on
    p's device, ``val`` [E] its values, float32 or int32 raw bits for
    ``fmt``; ``dang_idx`` the int32 list of dangling vertices; ``vmat``/``p``
    [V, K] in the value's domain.  ``res`` rows are (L1, ∞, Σd²) of
    |P_next − P| per column, raw units for fixed point; a zero ∞ row is an
    exact bit-equality certificate.
    """
    if p.device.type == "cpu":
        return fused_ppr_plain(topo, val, dang_idx, vmat, p, alpha=alpha, fmt=fmt)
    fixed = fmt is not None
    dom = torch.int32 if fixed else torch.float32
    num_vertices = topo.num_rows
    if p.dim() != 2 or p.shape[0] != num_vertices:
        raise ValueError(f"p must be [{num_vertices}, K] (the stream's rows), "
                         f"got {tuple(p.shape)}")
    vec = check_stream(topo, val, p, dom)
    check_operand(vmat, "vmat", dom, p.shape, align=4 * vec)
    check_operand(dang_idx, "dang_idx", torch.int32, dims=1)
    k = int(p.shape[1])
    n_ctas = -(-topo.num_slices // WARPS_PER_CTA)
    n_dang = int(dang_idx.shape[0])
    per_cta, n_part = _dangling_split(n_dang, n_ctas)
    row_lanes = COMBINE_THREADS // min(k // vec, COMBINE_THREADS)
    combine_ctas = max(1, min(-(-num_vertices // row_lanes), 2 * _sm_count(p.device)))
    new = dict(dtype=p.dtype, device=p.device)
    xp = torch.empty_like(p)
    carry = torch.empty((n_ctas, k), **new)
    dm_part = torch.empty((n_part, k), **new)
    dm = torch.empty(k, **new)
    p_next = torch.empty_like(p)
    res_part = torch.empty((combine_ctas, 3, k), dtype=torch.float32, device=p.device)
    res = torch.empty((3, k), dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device)
    tickets = _tickets(p.device, stream)
    lib = _build.load("fused_ppr", _declare)
    with torch.cuda.device(p.device):
        status = lib.fused_ppr_launch(
            topo.row_ptr.data_ptr(), topo.col.data_ptr(), val.data_ptr(),
            topo.nz_rows.data_ptr(), topo.slice_row.data_ptr(), dang_idx.data_ptr(),
            vmat.data_ptr(), p.data_ptr(), xp.data_ptr(), carry.data_ptr(),
            dm_part.data_ptr(), dm.data_ptr(), p_next.data_ptr(), res_part.data_ptr(),
            res.data_ptr(), tickets.data_ptr(), num_vertices,
            topo.num_edges, n_ctas, topo.slice_edges, k, n_dang, per_cta, n_part,
            combine_ctas, -(-num_vertices // combine_ctas), fmt.frac_bits if fixed else -1,
            *_combine_consts(fmt, num_vertices, alpha), vec, stream.cuda_stream)
    _raise_on(lib, status, "fused_ppr_iteration")
    fused_ppr_iteration.launches += 1
    return p_next, res


fused_ppr_iteration.launches = 0


def _declare(lib) -> None:
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.dangling_mass_launch.argtypes = [vp, vp, i, i, i, i, i, vp, vp, vp, vp]
    lib.dangling_mass_launch.restype = i
    lib.fused_ppr_launch.argtypes = ([vp] * 16 + [i] * 11 + [u] * 4 + [f] * 3
                                     + [i, vp])
    lib.fused_ppr_launch.restype = i
    lib.fused_ppr_error_string.argtypes = [i]
    lib.fused_ppr_error_string.restype = ctypes.c_char_p


def _raise_on(lib, status: int, what: str) -> None:
    if status:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fused_ppr_error_string(status).decode()}")
