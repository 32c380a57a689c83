"""Peaks of the chip and the bytes a wave's work needs.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the full 700 W limit).  A
card set below 700 W runs slower under load: its ``power.limit`` is
reported beside every share taken against these numbers.
"""
from __future__ import annotations

#: HBM3 bandwidth of one H100 SXM, bytes/s
HBM_BYTES_PER_S = 3.35e12


def wave_bytes(num_vertices: int, num_edges: int, num_dangling: int,
               kappa: int, iterations: int, k: int, elem_bytes: int = 4,
               index_bytes: int = 4) -> int:
    """HBM bytes one wave's work needs, each input read once and each output
    written once, counted from the graph and the wave alone (nothing of how
    the port lays the stream out).

    Each of the ``iterations`` reads the matrix once (per edge a source index
    and a value, per row an offset), the dangling list, the κ personalization
    vertices and the state P_t [V, κ], and writes P_{t+1}.  Top-K then reads
    the last state once and writes κ·k ids and scores."""
    per_iteration = (num_edges * (index_bytes + elem_bytes)
                     + (num_vertices + 1) * index_bytes
                     + num_dangling * index_bytes
                     + kappa * index_bytes
                     + 2 * num_vertices * kappa * elem_bytes)
    topk = num_vertices * kappa * elem_bytes + kappa * k * (index_bytes + elem_bytes)
    return iterations * per_iteration + topk


def roofline_pct(bytes_needed: float, device_seconds: float) -> float:
    """Share, in %, of the least time the bytes take at the HBM peak in the
    device time actually spent."""
    return 100.0 * (bytes_needed / HBM_BYTES_PER_S) / device_seconds
