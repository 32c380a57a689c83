"""Quantifying the paper's §3 format argument: COO streams at full utilization
on power-law graphs; row-oriented CSR/CSC lane-gangs stall on degree skew.

Counterpart of ``repro.core.csr_compare`` (numpy, over the port's
``BlockedCOO``).

The paper: "CSC-based designs often fail to handle graphs with exponential
distribution, especially if stream-like processing is demanded... COO
simplifies array partitioning, enables burst reads... as entries are
independent and the architecture is not bound to knowing the degree of each
vertex."

Model (matches both an FPGA lane-gang and a GPU warp-per-row design, where
each lane of a warp takes one row and the warp runs as long as its longest
row): a row-oriented engine processes G rows per wave across lanes; each wave
costs max(deg) cycles among its rows while lanes with shorter rows idle.  A
COO engine costs ceil(E/packet) waves at full width regardless of degrees.

  csr_utilization  = Σ deg / (Σ_waves G · max_deg_in_wave)
  coo_utilization  = E / (packets · packet_size)   (= 1/pad_overhead)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.coo import BlockedCOO, COOGraph


def csr_gang_utilization(g: COOGraph, gang: int = 8) -> float:
    """Lane utilization of a row-gang engine (rows sorted by id, G per wave)."""
    deg = np.bincount(g.x, minlength=g.num_vertices).astype(np.int64)
    pad = (-len(deg)) % gang
    if pad:
        deg = np.concatenate([deg, np.zeros(pad, np.int64)])
    waves = deg.reshape(-1, gang)
    cost = waves.max(axis=1).sum() * gang
    return float(deg.sum()) / max(1.0, float(cost))


def csr_gang_utilization_sorted(g: COOGraph, gang: int = 8) -> float:
    """Same engine with degree-sorted rows (the best case for CSR gangs —
    requires a full-graph sort + permutation, which breaks streaming)."""
    deg = np.sort(np.bincount(g.x, minlength=g.num_vertices).astype(np.int64))
    pad = (-len(deg)) % gang
    if pad:
        deg = np.concatenate([np.zeros(pad, np.int64), deg])
    waves = deg.reshape(-1, gang)
    cost = waves.max(axis=1).sum() * gang
    return float(deg.sum()) / max(1.0, float(cost))


def coo_utilization(g: COOGraph, v_tile: int = 4096, packet: int = 256) -> float:
    b = BlockedCOO.build(g, v_tile=v_tile, packet=packet)
    return 1.0 / b.pad_overhead


def format_comparison(g: COOGraph, gang: int = 8) -> Dict[str, float]:
    return {
        "coo_utilization": coo_utilization(g),
        "csr_gang_utilization": csr_gang_utilization(g, gang),
        "csr_sorted_utilization": csr_gang_utilization_sorted(g, gang),
    }
