"""Device meshes for the sharded PPR path (counterpart of ``repro.launch.mesh``
for the part the PPR engines read of a ``jax.sharding.Mesh``).

The reference's sharded serving is single-controller: one process runs
``shard_map`` over a mesh, and P, the dangling mass, the eq. (1) combine and
top-K stay on the replicated state.  The port keeps that shape: a ``Mesh``
is an array of torch devices in one process, each shard's SpMV runs on its
own device and its rows come back to the controller, ``devices[0]``.  No
``torch.distributed`` is involved: the reference runs no process group, and
one process drives every card of a host.  Where the host has fewer cards
than shards, ``make_mesh`` wraps the shards round the cards (on a one-card
host every shard sits on ``cuda:0``, as the reference's shards sit on
virtual CPU devices in its tests), so the partitioning, each shard's kernel
and the gather run as on a larger host, without copies between cards.

The reference's LM meshes, ``make_production_mesh`` and ``make_debug_mesh``,
are of another kind: ``torch.distributed.device_mesh.DeviceMesh``es over
the ranks of the default process group, with the reference's axis names,
for the sharding rules of ``distributed/`` (one rank a device, as
``jax.make_mesh`` takes one device a position).  The dry-run drivers build
them on a ``"fake"`` process group of 512 ranks, which needs no card.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_debug_mesh"]


class Mesh:
    """An n-d array of torch devices with named axes.

    ``shape`` maps each axis name to its size, ``axis_names`` is the tuple of
    names and ``devices`` the object array of ``torch.device``, as on a
    ``jax.sharding.Mesh``.  The controller, where the replicated state lives,
    is the first device."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.vectorize(torch.device, otypes=[object])(np.asarray(devices, dtype=object))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(f"devices of shape {arr.shape} do not fit the axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if len({d.type for d in arr.flat}) != 1:
            raise ValueError("a mesh holds devices of one type")
        self.devices = arr
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    @property
    def controller(self) -> torch.device:
        """The device that holds P, the combine and top-K."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis): shard
        ``i`` of a partition over ``axis`` runs on the i-th."""
        at = self.axis_names.index(axis)
        idx = tuple(slice(None) if a == at else 0 for a in range(len(self.axis_names)))
        return list(self.devices[idx])

    @property
    def placement(self) -> str:
        """Where the devices are, each with its count: ``cuda:0×4``."""
        return ", ".join(f"{d}×{n}" for d, n in Counter(map(str, self.devices.flat)).items())


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: Union[str, torch.device, None] = "cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axis_names``.

    With ``devices`` (as many as the shape holds, in row-major order) those
    devices; else on ``device``'s type: the CPU for every position, or
    ``cuda:{i % torch.cuda.device_count()}`` for position ``i``.  Asking for
    CUDA on a host without a GPU raises."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            devices = [torch.device("cuda", i % cards) for i in range(n)]
        else:
            devices = [dev] * n
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of shape {shape}")
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(shape), axis_names)


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    """A ``DeviceMesh`` over the first prod(shape) ranks of the default group
    (``jax.make_mesh`` takes the first devices likewise)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    world = torch.distributed.get_world_size()
    if world < n:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """Small mesh for CI-scale distributed tests (needs ≥ data·model ranks)."""
    return _device_mesh((data, model), ("data", "model"), device_type)
