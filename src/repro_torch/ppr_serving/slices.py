"""The parts of the PPR serving surface that a later slice of the port brings.

The service and the ``ppr_run`` driver raise ``not_ported(...)`` for an
option of the reference that is not ported yet (``register_graph(mesh=)``,
``ppr_run --shards N>1``), naming the slice it comes with.
"""
from __future__ import annotations

__all__ = ["MESH_SLICE", "not_ported"]

MESH_SLICE = "the multi-GPU slice"


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error to raise for ``what``, which comes with ``slice_name``."""
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{slice_name}")
