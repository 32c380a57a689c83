"""CPU fixtures of the benchmark's own tests: cells cut to a size the CPU
runs in a second, through the same harness the chip runs."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the CPU's sizes: graphs of 2,000 vertices and small deltas (tests run 0.4 s windows)
TINY_GRAPH = {"erdos_renyi": {"num_vertices": 2000, "num_edges": 20000},
              "holme_kim_powerlaw": {"num_vertices": 2000}}


def shrink(cell):
    """``cell`` at the CPU's sizes (its traffic's kinds unchanged)."""
    cell.config["graph"].update(TINY_GRAPH[cell.config["graph"]["generator"]])
    tr = cell.traffic
    if tr.get("deltas"):
        tr["deltas"].update(first_s=0.1, every_s=0.25, n_add=16, n_remove=8)
    if tr["loop"]["kind"] == "open":
        tr["loop"]["rate_per_s"] = 400
    if tr.get("cache_warm_queries"):
        tr["cache_warm_queries"] = 256
    return cell


@pytest.fixture
def tiny_cell():
    from portbench import harness

    return lambda workload: shrink(harness.load_cell(workload))


@pytest.fixture
def cpu_only():
    """The CPU device; skips where a card is present (a test of what a run
    does without one)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    return "cpu"
