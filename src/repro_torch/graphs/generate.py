"""Graph generators matching the paper's Table 1 datasets.

Counterpart of ``repro.graphs.generate`` (host numpy, copied: the same seed
gives the same graph in both packages).

The paper evaluates on 6 synthetic graphs (Erdős–Rényi G(n,p), Watts–Strogatz
small-world, Holme–Kim powerlaw-cluster; |V| ∈ {1e5, 2e5}, |E| ≈ 1e6/2e6) and 2
SNAP graphs (Amazon co-purchasing, Twitter social circles).

Generators are vectorized numpy (networkx equivalents are used in tests only as a
cross-check — pure-python generation of 2e6 edges is too slow for benchmarks).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.coo import COOGraph


def _dedup(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Remove duplicate and self edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * (dst.max(initial=0) + 1) + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def erdos_renyi(n: int, m: int, seed: int = 0) -> COOGraph:
    """G(n,M): M directed edges drawn uniformly (paper's G_{n,p} at same density)."""
    rng = np.random.default_rng(seed)
    over = int(m * 1.05) + 16
    src = rng.integers(0, n, over, dtype=np.int64)
    dst = rng.integers(0, n, over, dtype=np.int64)
    src, dst = _dedup(src, dst)
    src, dst = src[:m], dst[:m]
    return COOGraph.from_edges(src, dst, n)


def watts_strogatz(n: int, k: int = 10, beta: float = 0.1, seed: int = 0) -> COOGraph:
    """Small-world ring lattice with k neighbors, rewiring probability beta.

    Directed variant: each vertex points to its k/2 clockwise neighbors, and each
    such edge is rewired to a uniform target with probability beta.  Matches the
    paper's |E| = n·k/2 scaling (k=10 → 1e6 edges at n=2e5... n·k/2; the paper's
    1e5-vertex graph has exactly 1e6 edges ⇒ k=20).
    """
    rng = np.random.default_rng(seed)
    half = k // 2
    base = np.arange(n, dtype=np.int64)
    src = np.repeat(base, half)
    offs = np.tile(np.arange(1, half + 1, dtype=np.int64), n)
    dst = (src + offs) % n
    rewire = rng.random(src.shape[0]) < beta
    dst = np.where(rewire, rng.integers(0, n, src.shape[0], dtype=np.int64), dst)
    src, dst = _dedup(src, dst)
    return COOGraph.from_edges(src, dst, n)


def holme_kim_powerlaw(n: int, m: int = 10, p_triad: float = 0.1, seed: int = 0) -> COOGraph:
    """Holme–Kim powerlaw-cluster graph, vectorized preferential attachment.

    Each arriving vertex attaches m edges; with probability p_triad an edge closes
    a triangle instead of a fresh preferential pick.  We approximate preferential
    attachment by sampling from the running edge-endpoint list (the classic
    Barabási trick), which reproduces the powerlaw degree distribution the paper
    relies on ("dense communities, similarly to real social networks").
    """
    rng = np.random.default_rng(seed)
    # endpoint pool for preferential sampling; seed with a small clique
    m0 = m + 1
    pool = np.repeat(np.arange(m0, dtype=np.int64), m0 - 1)
    srcs = [np.repeat(np.arange(m0, dtype=np.int64), m0 - 1)]
    dsts = [np.tile(np.arange(m0, dtype=np.int64), m0)[: m0 * (m0 - 1)]]
    pool_list = [pool]
    pool_size = pool.shape[0]
    # batch arrivals for speed: sample targets against the *current* pool only
    batch = 2048
    pools = np.concatenate(pool_list)
    for start in range(m0, n, batch):
        stop = min(start + batch, n)
        nb = stop - start
        newv = np.arange(start, stop, dtype=np.int64)
        # sample m preferential targets per new vertex from the frozen pool
        tgt = pools[rng.integers(0, pool_size, (nb, m))]
        # triad closure: with prob p, replace target j>0 by a neighbor of target j-1
        # (approximated by re-using target j-1 offset by pool sampling locality)
        triad = rng.random((nb, m)) < p_triad
        triad[:, 0] = False
        tgt = np.where(triad, np.roll(tgt, 1, axis=1), tgt)
        s = np.repeat(newv, m)
        d = tgt.reshape(-1)
        srcs.append(s)
        dsts.append(d)
        pools = np.concatenate([pools, s, d])
        pool_size = pools.shape[0]
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    src, dst = _dedup(src, dst)
    return COOGraph.from_edges(src, dst, n)


def load_snap_edgelist(path: str, num_vertices: int | None = None) -> COOGraph:
    """Load a SNAP-format whitespace edge list (``# comment`` lines skipped)."""
    arr = np.loadtxt(path, dtype=np.int64, comments="#")
    src, dst = arr[:, 0], arr[:, 1]
    # densify ids
    ids, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    src = inv[: src.shape[0]]
    dst = inv[src.shape[0]:]
    n = num_vertices or int(ids.shape[0])
    return COOGraph.from_edges(src, dst, n)


def paper_graph_suite(scale: float = 1.0, seed: int = 0) -> Dict[str, COOGraph]:
    """The paper's Table 1 synthetic suite, optionally scaled down for CI.

    scale=1.0 reproduces |V|∈{1e5, 2e5}, |E|≈{1e6, 2e6}.  The two SNAP graphs are
    substituted by statistically matched synthetics when the raw files are absent
    (documented in DESIGN.md §9): amazon-like (powerlaw, |V|=128000, |E|≈443378)
    and twitter-like (dense powerlaw, |V|=81306, |E|≈1572670).
    """
    v1 = max(64, int(1e5 * scale))
    v2 = max(128, int(2e5 * scale))
    suite = {
        "gnp_1e5": erdos_renyi(v1, max(32, int(1e6 * scale)), seed),
        "gnp_2e5": erdos_renyi(v2, max(64, int(2e6 * scale)), seed + 1),
        "ws_1e5": watts_strogatz(v1, k=20, seed=seed + 2),
        "ws_2e5": watts_strogatz(v2, k=20, seed=seed + 3),
        "pl_1e5": holme_kim_powerlaw(v1, m=10, seed=seed + 4),
        "pl_2e5": holme_kim_powerlaw(v2, m=10, seed=seed + 5),
        "amazon_like": holme_kim_powerlaw(max(64, int(128000 * scale)), m=3, seed=seed + 6),
        "twitter_like": holme_kim_powerlaw(max(64, int(81306 * scale)), m=19,
                                           p_triad=0.3, seed=seed + 7),
    }
    return suite
