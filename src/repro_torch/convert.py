"""Carry state between the reference package and the port as numpy arrays.

The port never imports the reference.  Tests and tools that hold both hand
graphs and raw fixed-point states across with these, so that both packages
compute on the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coo import COOGraph

__all__ = ["graph_from_arrays", "raw_to_torch", "raw_to_numpy"]


def graph_from_arrays(x, y, val, dangling, num_vertices: int) -> COOGraph:
    """A port ``COOGraph`` from a reference graph's arrays (copied as they are:
    x/y int32, val float32, dangling bool)."""
    return COOGraph(num_vertices=int(num_vertices),
                    x=np.asarray(x, np.int32).copy(),
                    y=np.asarray(y, np.int32).copy(),
                    val=np.asarray(val, np.float32).copy(),
                    dangling=np.asarray(dangling, bool).copy())


def raw_to_torch(raw: np.ndarray, device="cpu") -> torch.Tensor:
    """np.uint32 raw Qm.f values → int32 tensor holding the same bits."""
    raw = np.ascontiguousarray(np.asarray(raw, np.uint32))
    return torch.from_numpy(raw.view(np.int32).copy()).to(device)


def raw_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of raw bits → np.uint32 array of the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)
