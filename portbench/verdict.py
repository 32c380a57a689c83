"""Whether the served answers are correct: each one judged against the plain
reference (``reference.py``) on the graph it was served on.

Two kinds of check, named by a traffic file's ``check`` and limited by
``checks/<name>.json``:

``fixed_exact``  Qm.f traffic.  The datapath is bit-exact by design, so every
                 answer must equal the reference's: ``rank_mismatch`` counts
                 answers whose vertex list differs (ties included),
                 ``raw_gap_lsb`` is the widest gap between a served score and
                 the reference's at the same rank, in units of 2**-f.
``float``        float32 traffic against a float64 reference:
                 ``score_gap`` is the widest gap between a served score and
                 the reference's score of the same vertex, ``rank_gap`` the
                 widest by which a served vertex's reference score lies below
                 the reference's score at that rank.

Both count ``bad_lists``: answers of the wrong length, with a repeated
vertex, a vertex out of range or the query's own vertex.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from portbench import reference as ref

CHECKS = Path(__file__).resolve().parent / "checks"
#: stands for an infinite gap in the printed numbers (JSON has no infinity)
HUGE = 1e30

Versions = Callable[[int], Tuple[np.ndarray, np.ndarray, int]]


def load_limits(name: str) -> Dict[str, float]:
    return json.loads((CHECKS / f"{name}.json").read_text())["limits"]


def _bad_lists(vertex: np.ndarray, ids: np.ndarray, num_vertices: int,
               k: int) -> int:
    bad = 0
    for v, row in zip(vertex, ids):
        if (row.shape[0] != k or len(set(row.tolist())) != k or int(v) in row
                or row.min() < 0 or row.max() >= num_vertices):
            bad += 1
    return bad


def judge(check: Dict, versions: Versions, answers: Dict[str, np.ndarray],
          device, *, alpha: float, iterations: int, block: int = 64
          ) -> Dict[str, float]:
    """The compared numbers of ``answers`` (``vertex``, ``version``, ``ids``,
    ``scores``, one row each) against the reference, version by version."""
    kind = check["kind"]
    k = answers["ids"].shape[1]
    n = answers["ids"].shape[0]
    numbers = ({"rank_mismatch": 0, "raw_gap_lsb": 0} if kind == "fixed_exact"
               else {"score_gap": 0.0, "rank_gap": 0.0})
    numbers["bad_lists"] = 0
    for j in np.unique(answers["version"]):
        src, dst, num_vertices = versions(int(j))
        g = ref.RefGraph(src, dst, num_vertices, device)
        rows = np.nonzero(answers["version"] == j)[0]
        verts = answers["vertex"][rows]
        numbers["bad_lists"] += _bad_lists(verts, answers["ids"][rows],
                                           num_vertices, k)
        uniq, inv = np.unique(verts, return_inverse=True)
        for b0 in range(0, uniq.shape[0], block):
            cols = uniq[b0:b0 + block]
            mine = np.nonzero((inv >= b0) & (inv < b0 + block))[0]
            col_of = inv[mine] - b0
            served_ids = answers["ids"][rows[mine]]
            served = answers["scores"][rows[mine]]
            if kind == "fixed_exact":
                P = ref.ppr_fixed(g, cols, check["int_bits"], check["frac_bits"],
                                  alpha, iterations)
                r_ids, r_raw = ref.topk_fixed(P, cols, k)
                raw = np.rint(served * float(1 << check["frac_bits"]))
                gap = np.abs(raw - r_raw[col_of])
                gap = np.where(np.isfinite(gap), gap, HUGE)
                numbers["raw_gap_lsb"] = max(numbers["raw_gap_lsb"], int(gap.max()))
                numbers["rank_mismatch"] += int(
                    (served_ids != r_ids[col_of]).any(axis=1).sum())
            else:
                P = ref.ppr_float(g, cols, alpha, iterations)
                S = ref.column_scores(P, cols)                    # [K, V]
                _, r_top = ref.topk_float(P, cols, k)
                ids_t = torch.as_tensor(np.clip(served_ids, 0, num_vertices - 1)
                                        .astype(np.int64), device=S.device)
                at = torch.gather(S[torch.as_tensor(col_of, device=S.device)],
                                  1, ids_t).cpu().numpy()
                with np.errstate(invalid="ignore"):
                    sg = np.abs(served - at)
                    rg = r_top[col_of] - at
                sg = np.where(np.isfinite(sg), sg, HUGE)
                rg = np.where(np.isfinite(rg), rg, HUGE)
                numbers["score_gap"] = max(numbers["score_gap"], float(sg.max()))
                numbers["rank_gap"] = max(numbers["rank_gap"],
                                          float(max(rg.max(), 0.0)))
            del P
    numbers["checked"] = n
    return numbers


def sample_rows(n_answered: int, size: int, rng: np.random.Generator
                ) -> np.ndarray:
    """Up to ``size`` answer indices drawn without replacement, sorted."""
    if n_answered <= size:
        return np.arange(n_answered)
    return np.sort(rng.choice(n_answered, size=size, replace=False))
