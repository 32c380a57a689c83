from repro_torch.graphs.generate import (
    erdos_renyi,
    holme_kim_powerlaw,
    load_snap_edgelist,
    paper_graph_suite,
    watts_strogatz,
)
from repro_torch.graphs.reference import ppr_reference

__all__ = [
    "erdos_renyi",
    "watts_strogatz",
    "holme_kim_powerlaw",
    "load_snap_edgelist",
    "paper_graph_suite",
    "ppr_reference",
]
