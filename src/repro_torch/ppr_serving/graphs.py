"""Registered-graph state holders — host topology + device upload caches.

Counterpart of ``repro.ppr_serving.graphs``.  Every upload of a
``RegisteredGraph`` goes to the graph's ``device`` — the service's; a
``ShardedRegisteredGraph`` keeps its replicated state on its mesh's
controller and each shard's stream on that shard's device.

What lives here is what every engine shares: the unpadded host graph (the
delta base), packet padding, the out-degree vector, the host-side raw
quantization cache, the full-layout device arrays, and the host-side
incremental merge of edge deltas — surviving edges keep their raw bits, only
entries whose source out-degree moved are requantized, bit-identical to
quantizing the merged graph from scratch.  ``epoch`` counts applied deltas;
the service stamps it into cache keys and wave keys so results computed on
different topologies never alias.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.coo import COOGraph, EdgeMergeInfo, quantize_values
from repro_torch.core.fixed_point import QFormat
from repro_torch.core.spmv import sharded_vertex_layout
from repro_torch.device import resolve_device
from repro_torch.ppr_serving.telemetry import SINGLE_DEVICE_KEY

__all__ = ["RegisteredGraph", "ShardedRegisteredGraph"]


class RegisteredGraph:
    """Host-side graph state prepared once at registration and patched in
    place by edge deltas, plus the full-layout device upload cache.

    The full-layout edge stream (``x``/``y``/``val``) is uploaded eagerly —
    every single-device wave reads it — unless a subclass defers it because
    its waves read another layout."""

    mesh_key = SINGLE_DEVICE_KEY   # waves on this graph run single-device
    engine_family = "single"

    _defer_full_upload = False

    def __init__(self, name: str, g: COOGraph, packet: int = 256, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.source = g                      # unpadded host graph
        self.packet = packet
        self.epoch = 0
        self.graph = g.pad_to_packets(packet)
        self.num_vertices = g.num_vertices
        self.dangling = torch.as_tensor(self.graph.dangling, device=self.device)
        self._outdeg = np.bincount(g.y, minlength=g.num_vertices).astype(np.int64)
        self._full_device: Optional[Tuple[torch.Tensor, ...]] = None
        self._quantized: Dict[QFormat, torch.Tensor] = {}
        self._quantized_host: Dict[QFormat, np.ndarray] = {}   # unpadded uint32
        self._stale_device_formats: set = set()
        self._full_was_materialized = False
        self._armed: Dict[str, object] = {}    # engine key → engine instance
        #: host seconds of the last delta's stages ("merge", "requantize",
        #: then each refresh's own), for the operator and the chip script
        self.delta_timings: Dict[str, float] = {}
        #: host seconds of what registration built for the graph's family
        #: (the fused family: its dst stream's "stream" build and "upload")
        self.register_timings: Dict[str, float] = {}
        if not self._defer_full_upload:
            self.device_full()

    # ---- engine bookkeeping -----------------------------------------------
    def arm(self, engine) -> None:
        """Record an engine as serving this graph — armed engines get the
        ``on_delta`` device-refresh callback after each edge delta."""
        self._armed[engine.key] = engine

    def armed_engines(self):
        return tuple(self._armed.values())

    # ---- device upload caches ---------------------------------------------
    def device_full(self) -> Tuple[torch.Tensor, ...]:
        """The full-layout (packet-padded) device arrays ``(x, y, val)``."""
        if self._full_device is None:
            self._full_device = tuple(
                torch.as_tensor(a, device=self.device)
                for a in (self.graph.x, self.graph.y, self.graph.val))
        return self._full_device

    @property
    def x(self) -> torch.Tensor:
        return self.device_full()[0]

    @property
    def y(self) -> torch.Tensor:
        return self.device_full()[1]

    @property
    def val(self) -> torch.Tensor:
        return self.device_full()[2]

    def _quantize_host(self, fmt: QFormat) -> np.ndarray:
        """Raw uint32 values of the *unpadded* edge stream (host-side cache)."""
        if fmt not in self._quantized_host:
            self._quantized_host[fmt] = self.source.quantized_val(fmt)
        return self._quantized_host[fmt]

    def quantized(self, fmt: QFormat) -> torch.Tensor:
        """Padded raw device values for ``fmt`` (int32 bits, cached upload)."""
        if fmt not in self._quantized:
            raw = self._quantize_host(fmt)
            pad = self.graph.num_edges - raw.shape[0]
            if pad:
                raw = np.concatenate([raw, np.zeros(pad, np.uint32)])
            self._quantized[fmt] = torch.as_tensor(raw.view(np.int32),
                                                   device=self.device)
        return self._quantized[fmt]

    # ---- delta ingestion --------------------------------------------------
    def apply_delta(self, delta) -> EdgeMergeInfo:
        """Merge an edge delta (``graph_updates.EdgeDelta``) into the host
        state; bumps ``epoch``.

        Pre-registered Q formats are requantized incrementally: surviving
        edges keep their raw bits (copied through the merge's old→new index
        map), only ``changed_mask`` entries — edges of sources whose
        out-degree moved — go through the quantizer again.  The result is
        bit-identical to quantizing the merged graph from scratch.

        Device caches become stale here and are released; the graph's armed
        engines refresh them through ``on_delta`` (the service drives that
        loop), so device costs are paid at delta time, not smeared over the
        next waves."""
        t0 = time.perf_counter()
        new_g, info = delta.apply(self.source, outdeg=self._outdeg)
        self._outdeg = info.new_outdeg
        self.source = new_g
        self.graph = new_g.pad_to_packets(self.packet)
        self.num_vertices = new_g.num_vertices
        t1 = time.perf_counter()
        for fmt, old_raw in list(self._quantized_host.items()):
            new_raw = np.zeros(new_g.num_edges, np.uint32)
            new_raw[info.new_pos_of_kept] = old_raw[info.kept_old_idx]
            if info.changed_mask.any():
                new_raw[info.changed_mask] = quantize_values(
                    new_g.val[info.changed_mask], fmt)
            self._quantized_host[fmt] = new_raw
        t2 = time.perf_counter()
        self._stale_device_formats |= set(self._quantized)
        self._quantized.clear()
        self._full_was_materialized = self._full_device is not None
        self._full_device = None
        self.dangling = torch.as_tensor(self.graph.dangling, device=self.device)
        self.epoch += 1
        self.delta_timings = {"merge": t1 - t0, "requantize": t2 - t1,
                              "upload_dangling": time.perf_counter() - t2}
        return info

    def refresh_device_base(self) -> None:
        """Re-upload the base device caches a delta invalidated — previously
        uploaded quantized formats, and the full layout if it was materialized
        (or this graph uploads eagerly).  Idempotent across armed engines."""
        t0 = time.perf_counter()
        for fmt in tuple(self._stale_device_formats):
            self.quantized(fmt)
        self._stale_device_formats.clear()
        if self._full_was_materialized or not self._defer_full_upload:
            self.device_full()
        self.delta_timings["upload_base"] = (self.delta_timings.get("upload_base", 0.0)
                                             + time.perf_counter() - t0)


class ShardedRegisteredGraph(RegisteredGraph):
    """A registered graph whose edge stream is partitioned by destination
    range over one axis of a ``launch.mesh.Mesh`` (the paper's multi-channel
    partitioning, scaled to several devices): waves on it run the sharded
    engines.

    Holds the bucketed host layout (``_host_x``/``_host_y``/``_host_val``,
    one row per shard, and ``_sharded_quant_host`` per prepared format, as
    the reference keeps them) and beside it one pad-free dst stream per
    shard (``shard_streams``) with its uploads on the shard's device.  P,
    the dangling vector, the combine and top-K live on the mesh's
    controller, which is the graph's ``device``.  The partitioning and the
    per-bucket delta refresh live in ``repro_torch.ppr_serving.engine.sharded``."""

    engine_family = "sharded"

    _defer_full_upload = True

    def __init__(self, name: str, g: COOGraph, mesh, axis: Optional[str] = None,
                 packet: int = 256, device=None):
        controller = mesh.controller
        if device is not None and resolve_device(device).type != controller.type:
            raise ValueError(f"the mesh's devices are {controller.type}, the "
                             f"graph's device is {resolve_device(device)}")
        self.mesh = mesh
        self.axis = axis if axis is not None else mesh.axis_names[0]
        if self.axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {self.axis!r} "
                             f"(axes: {mesh.axis_names})")
        self.n_shards = int(mesh.shape[self.axis])
        self.mesh_key = f"mesh:{self.axis}x{self.n_shards}"
        self.shard_devices = mesh.axis_devices(self.axis)
        self._sharded_quant_host: Dict[QFormat, np.ndarray] = {}  # [S, max_e]
        self._sharded_quantized: Dict[QFormat, torch.Tensor] = {}  # [S·max_e] raw int32
        self.shard_streams: List = []
        self._sharded_stale = False
        self._pre_delta_v_local = 0
        #: shards the last delta refresh rebuilt; None for a full re-partition
        self.last_refresh_shards: Optional[List[int]] = None
        super().__init__(name, g, packet=packet, device=controller)
        from repro_torch.ppr_serving.engine.sharded import partition_topology
        partition_topology(self)

    def sharded_quantized(self, fmt: QFormat) -> torch.Tensor:
        """Raw edge shard values in the partitioned layout (cached until the
        partition changes): int32 holding the reference's uint32 bits,
        [S·max_e], on the controller.  Built on first call; no served path
        reads it."""
        from repro_torch.ppr_serving.engine.sharded import partition_format
        if fmt not in self._sharded_quantized:
            self._sharded_quantized[fmt] = partition_format(self, fmt).to(self.device,
                                                                          copy=True)
        return self._sharded_quantized[fmt]

    def apply_delta(self, delta) -> EdgeMergeInfo:
        """Host merge plus the bookkeeping the sharded engines' per-bucket
        refresh needs: the pre-merge ceil-division layout (vertex growth may
        move it) and a staleness latch making the refresh idempotent across
        the family's two armed engines."""
        self._pre_delta_v_local, _ = sharded_vertex_layout(self.num_vertices,
                                                           self.n_shards)
        info = super().apply_delta(delta)
        self._sharded_stale = True
        return info
