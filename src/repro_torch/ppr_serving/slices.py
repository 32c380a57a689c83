"""The parts of the PPR serving surface that later slices of the port bring.

The service and the ``ppr_run`` driver raise ``not_ported(...)`` for an
option of the reference that is not ported yet, naming the slice it comes
with.
"""
from __future__ import annotations

__all__ = ["OBS_SLICE", "MESH_SLICE", "HTTP_SLICE", "not_ported"]

OBS_SLICE = "the observability slice (tracing, SLO, OTLP)"
MESH_SLICE = "the multi-GPU slice"
HTTP_SLICE = "the HTTP slice"


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error to raise for ``what``, which comes with ``slice_name``."""
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{slice_name}")
