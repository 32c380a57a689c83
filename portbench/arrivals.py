"""The one traffic generator: query streams and delta schedules from a seed.

A traffic file (``traffic/<name>.json``) holds only parameters; this module
turns them into the draws of one run.  Every stream comes from its own child
of the run's ``SeedSequence``, so the same seed gives the same queries,
arrival times and deltas whatever the run's timing.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: child streams of a run's seed (fixed: a new stream takes a new number)
STREAMS = {"graph": 0, "queries": 1, "arrivals": 2, "deltas": 3, "sample": 4,
           "warmup": 5, "zipf_perm": 6}


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """The ``stream`` child of ``seed`` (any whole number; taken mod 2**64)."""
    ss = np.random.SeedSequence(entropy=int(seed) % (1 << 64),
                                spawn_key=(STREAMS[stream],))
    return np.random.default_rng(ss)


class VertexStream:
    """Query vertices in chunks, drawn from one seeded stream: a closed loop
    takes as many as its window lets it, and the first n are the same for
    every run of a seed."""

    def __init__(self, spec: Dict, num_vertices: int, seed: int,
                 stream: str = "queries", chunk: int = 1 << 16):
        self.spec = spec
        self.num_vertices = num_vertices
        self.rng = rng_for(seed, stream)
        self.chunk = chunk
        self._buf = np.zeros(0, np.int64)
        self._pos = 0
        self._zipf = None
        if spec["dist"] == "zipf":
            ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
            w = ranks ** -float(spec["s"])
            cdf = np.cumsum(w)
            self._zipf = (cdf / cdf[-1],
                          rng_for(seed, "zipf_perm").permutation(num_vertices))
        elif spec["dist"] != "uniform":
            raise ValueError(f"unknown vertex distribution {spec['dist']!r}")

    def draw(self, n: int) -> np.ndarray:
        """The next ``n`` vertices of the stream (a fresh draw, not the buffer)."""
        if self._zipf is None:
            return self.rng.integers(0, self.num_vertices, n, dtype=np.int64)
        cdf, perm = self._zipf
        idx = np.searchsorted(cdf, self.rng.random(n), side="right")
        return perm[np.minimum(idx, self.num_vertices - 1)]

    def next(self) -> int:
        if self._pos == self._buf.shape[0]:
            self._buf = self.draw(self.chunk)
            self._pos = 0
        v = int(self._buf[self._pos])
        self._pos += 1
        return v


def open_arrivals(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of an open loop: exactly
    ``round(rate * seconds)`` arrivals, uniform over the window and sorted —
    a Poisson process conditioned on its count, so every seed offers the
    same number of queries."""
    n = int(round(rate_per_s * seconds))
    return np.sort(rng_for(seed, "arrivals").uniform(0.0, seconds, n))


def delta_times(spec: Optional[Dict], seconds: float) -> np.ndarray:
    """When each delta is due (s from the window's start): ``first_s``, then
    every ``every_s``, while inside the window."""
    if not spec:
        return np.zeros(0)
    t = np.arange(float(spec["first_s"]), float(seconds), float(spec["every_s"]))
    return t
