"""The paper's own workload as a mesh configuration (counterpart of
``repro.configs.ppr_paper``; the numbers are the reference's).

The paper's single-FPGA envelope was |V| ≤ 1M (URAM-bound), |E| ≤ 5B
(DRAM-bound), κ = 8–16.  ``PPR_PAPER_1M`` is that envelope for one mesh of
dst-range shards (``core.spmv.partition_edges_by_dst``); ``PPR_POD_16M``
is the reference's pod-scale cut, 16× the vertices and edges.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PPRWorkload:
    name: str
    num_vertices: int
    num_edges: int
    kappa: int                 # personalization vertices per data shard
    bits: int                  # fixed-point width (paper: 20/22/24/26)
    iterations: int = 10
    alpha: float = 0.85


# paper-faithful single-FPGA envelope, on one model-axis group
PPR_PAPER_1M = PPRWorkload("ppr-paper-1m", num_vertices=1 << 20,
                           num_edges=16 << 20, kappa=16, bits=26)

# pod-scale: 16M vertices over the model axis, 16 κ-groups over data
PPR_POD_16M = PPRWorkload("ppr-pod-16m", num_vertices=16 << 20,
                          num_edges=256 << 20, kappa=16, bits=26)

PPR_WORKLOADS = {w.name: w for w in [PPR_PAPER_1M, PPR_POD_16M]}
