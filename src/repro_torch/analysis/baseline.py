"""Findings baseline: a committed ledger of accepted findings.

Counterpart of ``repro.analysis.baseline``, with the port's own file name.

The goal state is an **empty** baseline — every finding is either fixed or
carries an inline ``# repro: allow[...] reason``.  The baseline exists for
the migration window when a new rule lands against a tree with pre-existing
findings: ``--write-baseline`` records them (each entry may carry a
``reason``), ``--check`` then fails only on *new* findings — and also on
*stale* entries, so the ledger can only shrink.

Matching is line-insensitive (``rule``, ``path``, ``message``): an entry
survives unrelated edits above the finding but dies with any change to the
finding itself.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Tuple

from .core import AnalysisResult, Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "ANALYSIS_torch_baseline.json"


def dump_baseline(result: AnalysisResult) -> str:
    entries = [
        {"rule": f.rule_id, "path": f.path, "message": f.message,
         "reason": ""}
        for f in result.findings
    ]
    return json.dumps({"version": BASELINE_VERSION, "findings": entries},
                      indent=2, sort_keys=True) + "\n"


def load_baseline(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {payload.get('version')!r} in {path}")
    entries = payload.get("findings", [])
    for e in entries:
        if not all(isinstance(e.get(k), str) for k in ("rule", "path", "message")):
            raise ValueError(f"malformed baseline entry in {path}: {e!r}")
    return entries


def apply_baseline(
    findings: List[Finding], entries: List[dict]
) -> Tuple[List[Finding], List[dict]]:
    """Split ``findings`` against the baseline.

    Returns ``(new_findings, stale_entries)``: findings not covered by any
    entry, and entries that matched nothing (stale — they must be removed so
    the ledger only shrinks).  Multiset semantics: one entry absorbs one
    finding."""
    budget: Counter = Counter(
        (e["rule"], e["path"], e["message"]) for e in entries)
    new: List[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(f)
    stale_keys: Dict[Tuple[str, str, str], int] = {
        k: n for k, n in budget.items() if n > 0}
    stale: List[dict] = []
    for e in entries:
        k = (e["rule"], e["path"], e["message"])
        if stale_keys.get(k, 0) > 0:
            stale_keys[k] -= 1
            stale.append(e)
    return new, stale
