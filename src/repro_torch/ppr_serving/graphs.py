"""Registered-graph state holders — host topology + device upload caches.

Counterpart of ``repro.ppr_serving.graphs`` (``RegisteredGraph`` only: the
sharded graph comes with the multi-GPU slice, ``apply_delta`` with the delta
slice).  Every upload goes to the graph's ``device`` — the service's.

What lives here is what every engine shares: the unpadded host graph, packet
padding, the host-side raw quantization cache and the full-layout device
arrays.  ``epoch`` counts applied deltas; the service stamps it into cache
keys and wave keys so results computed on different topologies never alias.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.coo import COOGraph
from repro_torch.core.fixed_point import QFormat
from repro_torch.device import resolve_device
from repro_torch.ppr_serving.telemetry import SINGLE_DEVICE_KEY

__all__ = ["RegisteredGraph"]


class RegisteredGraph:
    """Host-side graph state prepared once at registration, plus the
    full-layout device upload cache.

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
        self._full_device: Optional[Tuple[torch.Tensor, ...]] = None
        self._quantized: Dict[QFormat, torch.Tensor] = {}
        self._quantized_host: Dict[QFormat, np.ndarray] = {}   # unpadded uint32
        if not self._defer_full_upload:
            self.device_full()

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
