"""Graphs and edge deltas from a seed: frozen copies of the port's generators.

``erdos_renyi`` and ``holme_kim_powerlaw`` follow ``repro_torch.graphs.
generate`` call for call (the same ``Generator`` draws in the same order),
and ``delta_batch`` draws its added edges as ``random_delta`` does.  They
are copied here so that a later change to the port's generators cannot move
the yardstick.  Each returns raw ``src -> dst`` edge arrays; building the
transition matrix from them is each side's own business (the port's
``COOGraph.from_edges``, the reference's ``reference.RefGraph``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Edges = Tuple[np.ndarray, np.ndarray]


def _dedup(src: np.ndarray, dst: np.ndarray) -> Edges:
    """Drop self edges and duplicate edges (the first of each pair kept
    in key order, as the port's generator does)."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * (dst.max(initial=0) + 1) + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def erdos_renyi(n: int, m: int, rng: np.random.Generator) -> Edges:
    """G(n, M): M directed edges drawn uniformly, no self or duplicate edge."""
    over = int(m * 1.05) + 16
    src = rng.integers(0, n, over, dtype=np.int64)
    dst = rng.integers(0, n, over, dtype=np.int64)
    src, dst = _dedup(src, dst)
    return src[:m], dst[:m]


def holme_kim_powerlaw(n: int, m: int, p_triad: float,
                       rng: np.random.Generator) -> Edges:
    """Holme-Kim powerlaw-cluster graph by batched preferential attachment
    over the running endpoint pool, with triad closure at ``p_triad``."""
    m0 = m + 1
    pools = np.repeat(np.arange(m0, dtype=np.int64), m0 - 1)
    srcs = [np.repeat(np.arange(m0, dtype=np.int64), m0 - 1)]
    dsts = [np.tile(np.arange(m0, dtype=np.int64), m0)[: m0 * (m0 - 1)]]
    pool_size = pools.shape[0]
    batch = 2048
    for start in range(m0, n, batch):
        stop = min(start + batch, n)
        nb = stop - start
        newv = np.arange(start, stop, dtype=np.int64)
        tgt = pools[rng.integers(0, pool_size, (nb, m))]
        triad = rng.random((nb, m)) < p_triad
        triad[:, 0] = False
        tgt = np.where(triad, np.roll(tgt, 1, axis=1), tgt)
        s = np.repeat(newv, m)
        d = tgt.reshape(-1)
        srcs.append(s)
        dsts.append(d)
        pools = np.concatenate([pools, s, d])
        pool_size = pools.shape[0]
    return _dedup(np.concatenate(srcs), np.concatenate(dsts))


GENERATORS = {
    "erdos_renyi": lambda spec, rng: erdos_renyi(
        spec["num_vertices"], spec["num_edges"], rng),
    "holme_kim_powerlaw": lambda spec, rng: holme_kim_powerlaw(
        spec["num_vertices"], spec["m"], spec["p_triad"], rng),
}


def make_graph(spec: Dict, rng: np.random.Generator) -> Edges:
    """The edges of a configuration's ``graph`` entry."""
    return GENERATORS[spec["generator"]](spec, rng)


def delta_batch(src: np.ndarray, num_vertices: int, count: int, n_add: int,
                n_remove: int, rng: np.random.Generator) -> List[Dict]:
    """``count`` deltas against a graph of ``len(src)`` edges, drawn at once.

    The removals of all deltas are drawn together without replacement from
    the original edges (indices into ``src``), so each names an edge that no
    earlier delta removed; the additions are uniform endpoint pairs, as
    ``random_delta`` draws them.  Each delta is
    ``{"remove": [n_remove] edge indices, "add_src", "add_dst"}``."""
    rem = rng.choice(src.shape[0], size=count * n_remove, replace=False)
    out = []
    for j in range(count):
        add_src = rng.choice(num_vertices, size=n_add).astype(np.int64)
        add_dst = rng.choice(num_vertices, size=n_add).astype(np.int64)
        out.append({"remove": rem[j * n_remove:(j + 1) * n_remove],
                    "add_src": add_src, "add_dst": add_dst})
    return out
