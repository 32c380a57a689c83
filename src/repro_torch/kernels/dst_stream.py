"""The pad-free, dst-sorted edge stream that both PPR kernels read.

No counterpart in the reference: its Pallas kernels stream the packet-padded
layouts (``BlockedCOO`` packets, ``FusedLayout`` rows).  ``build_dst_stream``
takes the form an entry point already holds — a ``BlockedCOO`` (through
``ops.packet_metadata``), a ``FusedLayout`` (through ``fused_schedule``), or
edge arrays ``(dst, src, val, num_rows)`` such as a ``COOGraph``'s own (the
fused family's served stream) or one shard's bucket of
``partition_edges_by_dst`` — globalises its local indices, drops every pad
slot and sorts the real edges stably by global dst.  A real
edge has value 1/outdeg > 0 and a pad has 0.0, so dropping the zero-valued
slots is exact in float32 and in fixed point.  The result is CSR over dst
rows:

- ``row_ptr`` [rows+1] int32, ``col`` [E] int32 global src;
- ``val`` [E] float32 on the host: a Q format's raw values are
  ``quantize_values(val, fmt)``, per edge, so bit-identical to quantizing the
  packet rows;
- ``nz_rows`` [R] int32: the rows with at least one edge, ascending;
- the work schedule: the stream is cut into slices of ``slice_edges`` edges,
  one warp each, ``WARPS_PER_CTA`` slices a CTA (a chunk of a few thousand
  edges); ``slice_row[j]`` is the index in ``nz_rows`` of the row of slice
  j's first edge, and ``slice_row[num_slices]`` that of the last edge's row,
  so slice j touches ``nz_rows[slice_row[j] .. slice_row[j + 1]]``.  A row
  cut by a slice boundary is joined inside its CTA; one cut by a CTA's chunk
  boundary is closed by a row-parallel fix-up.

The device holds only this stream (``topology``/``values`` upload it, once
per device and format); the padded arrays stay on the host.  ``topology``
gives a ``StreamTopology``: the index arrays with the ``slice_edges`` their
schedule was cut at, the one operand through which the kernels take a stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.coo import BlockedCOO, quantize_values
from repro_torch.core.fixed_point import QFormat
from repro_torch.kernels.coo_spmv import MAX_SLICE_EDGES, WARPS_PER_CTA
from repro_torch.kernels.fused_ppr import FusedLayout, fused_schedule

__all__ = ["DstStream", "StreamTopology", "build_dst_stream"]

_TARGET_CTAS = 1000        # 256-edge slices at the paper's sizes, the best on the H100


_INDEX = ("row_ptr", "col", "nz_rows", "slice_row")


@dataclasses.dataclass(frozen=True)
class StreamTopology:
    """A stream's index arrays on one device, with the slice size their
    schedule was cut at and the P rows the stream reads (1 + its largest
    src), so that the kernels never meet a schedule cut at another size."""
    row_ptr: torch.Tensor      # [num_rows+1] int32
    col: torch.Tensor          # [E] int32
    nz_rows: torch.Tensor      # [R] int32
    slice_row: torch.Tensor    # [num_slices+1] int32
    slice_edges: int
    src_rows: int

    @property
    def num_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.col.shape[0])

    @property
    def num_slices(self) -> int:
        return int(self.slice_row.shape[0]) - 1

    def to(self, device) -> "StreamTopology":
        return dataclasses.replace(self, **{n: getattr(self, n).to(device) for n in _INDEX})


@dataclasses.dataclass
class DstStream:
    """CSR over dst rows of the real edges, with the kernels' slice schedule."""
    num_rows: int
    row_ptr: np.ndarray        # [num_rows+1] int32
    col: np.ndarray            # [E] int32 global src
    val: np.ndarray            # [E] float32, every one > 0
    nz_rows: np.ndarray        # [R] int32 rows with an edge, ascending
    slice_edges: int           # edges a warp takes; a multiple of 32
    slice_row: np.ndarray      # [num_slices+1] int32 index in nz_rows (see above)
    _device: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    #: host seconds of the uploads ``topology`` and ``values`` made, summed
    upload_s: float = dataclasses.field(default=0.0, repr=False, compare=False)

    @property
    def num_edges(self) -> int:
        return int(self.col.shape[0])

    @property
    def num_slices(self) -> int:
        return int(self.slice_row.shape[0]) - 1

    @property
    def num_ctas(self) -> int:
        return -(-self.num_slices // WARPS_PER_CTA)

    def raw_values(self, fmt: Optional[QFormat] = None) -> np.ndarray:
        """[E] float32 values, or int32 raw bits of ``fmt``."""
        if fmt is None:
            return self.val
        return quantize_values(self.val, fmt).view(np.int32)

    def topology(self, device) -> StreamTopology:
        """The stream's ``StreamTopology`` on ``device`` (uploaded once)."""
        key = ("topology", str(device))
        if key not in self._device:
            t0 = time.perf_counter()
            self._device[key] = StreamTopology(
                **{n: torch.as_tensor(np.ascontiguousarray(getattr(self, n)), device=device)
                   for n in _INDEX},
                slice_edges=self.slice_edges,
                src_rows=int(self.col.max()) + 1 if self.num_edges else 0)
            self.upload_s += time.perf_counter() - t0
        return self._device[key]

    def values(self, device, fmt: Optional[QFormat] = None) -> torch.Tensor:
        """[E] values on ``device``: float32, or int32 raw bits of ``fmt``."""
        key = ("values", str(device), fmt)
        if key not in self._device:
            t0 = time.perf_counter()
            self._device[key] = torch.as_tensor(self.raw_values(fmt), device=device)
            self.upload_s += time.perf_counter() - t0
        return self._device[key]

    def release(self) -> List[Tuple]:
        """Drop every device upload of this stream (the tensors go once no
        caller holds them) and return what was uploaded, as keys
        ``("topology", device)`` and ``("values", device, fmt)``."""
        keys = list(self._device)
        self._device.clear()
        return keys


def _blocked_edges(b: BlockedCOO):
    from repro_torch.kernels.ops import packet_metadata   # ops imports this module
    packet_dst, packet_src, _, _ = packet_metadata(b)
    n, pk = packet_src.shape[0], b.packet
    dst = packet_dst.astype(np.int64)[:, None] * b.v_tile + b.x_local.reshape(n, pk)
    src = packet_src.astype(np.int64)[:, None] * b.v_tile + b.y_local.reshape(n, pk)
    return dst.ravel(), src.ravel(), b.val, b.n_dst * b.v_tile


def _layout_edges(lay: FusedLayout):
    row_off, row_src = fused_schedule(lay)
    n = row_src.shape[0]
    row_dst = np.repeat(np.arange(lay.n_blk, dtype=np.int64), np.diff(row_off))
    dst = row_dst[:, None] * lay.v_tile + lay.x2[:n]
    src = row_src.astype(np.int64)[:, None] * lay.v_tile + lay.y2[:n]
    return dst.ravel(), src.ravel(), lay.val2[:n].ravel(), lay.num_vertices


def _pick_slice_edges(num_edges: int) -> int:
    per_warp = -(-num_edges // (_TARGET_CTAS * WARPS_PER_CTA))
    return int(min(MAX_SLICE_EDGES, max(32, -(-per_warp // 32) * 32)))


def build_dst_stream(source: Union[BlockedCOO, FusedLayout, Tuple],
                     slice_edges: Optional[int] = None) -> DstStream:
    """The pad-free dst stream of a ``BlockedCOO`` (rows: n_dst·v_tile, the
    SpMV's output rows), a ``FusedLayout`` (rows: |V|) or edge arrays
    ``(dst, src, val, num_rows)`` (float32 values; rows: ``num_rows``).

    ``slice_edges`` (a multiple of 32, at most ``MAX_SLICE_EDGES``) defaults
    to the size that gives about a thousand CTAs."""
    if isinstance(source, BlockedCOO):
        dst, src, val, num_rows = _blocked_edges(source)
    elif isinstance(source, FusedLayout):
        dst, src, val, num_rows = _layout_edges(source)
    elif isinstance(source, tuple) and len(source) == 4:
        dst, src, val, num_rows = source
        dst, src = np.asarray(dst, np.int64), np.asarray(src, np.int64)
    else:
        raise TypeError(f"build_dst_stream takes a BlockedCOO, a FusedLayout or "
                        f"(dst, src, val, num_rows), not {type(source).__name__}")
    real = np.asarray(val) != 0
    dst, src, val = dst[real], src[real], np.asarray(val, np.float32)[real]
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=num_rows)
    if counts.shape[0] != num_rows:
        raise ValueError(f"an edge's dst lies beyond the stream's {num_rows} rows")
    num_edges = int(dst.shape[0])
    if num_edges >= 2 ** 31 - MAX_SLICE_EDGES:
        raise ValueError(f"{num_edges} edges: the kernels index the stream in int32")
    row_ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    s = _pick_slice_edges(num_edges) if slice_edges is None else int(slice_edges)
    if s % 32 or not 32 <= s <= MAX_SLICE_EDGES:
        raise ValueError(f"slice_edges={s}: a multiple of 32 in [32, {MAX_SLICE_EDGES}]")
    n_slices = max(1, -(-num_edges // s))
    nz_rows = np.nonzero(counts)[0]
    # index in nz_rows of the row of each slice's first edge, then of the last edge
    firsts = np.minimum(np.arange(n_slices + 1, dtype=np.int64) * s, max(num_edges - 1, 0))
    slice_row = np.searchsorted(row_ptr[nz_rows + 1], firsts, side="right") if num_edges \
        else np.zeros(n_slices + 1, np.int64)
    return DstStream(
        num_rows=int(num_rows), row_ptr=row_ptr.astype(np.int32),
        col=src[order].astype(np.int32), val=val[order],
        nz_rows=nz_rows.astype(np.int32), slice_edges=s,
        slice_row=slice_row.astype(np.int32))

