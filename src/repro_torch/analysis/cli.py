"""``python -m repro_torch.analysis`` — the port's analyzer CLI.

Counterpart of ``repro.analysis.cli``: the same flags and exit codes.

Usage:
    python -m repro_torch.analysis [paths...] [--check] [--json FILE]
                                   [--baseline FILE] [--write-baseline]
                                   [--list-rules] [--root DIR]

Default paths: ``src/repro_torch examples_torch`` under ``--root`` (the repo
root, default cwd).  Exit codes: 0 clean, 1 findings (or stale baseline
entries under ``--check``), 2 usage errors.  The port's committed report is
``ANALYSIS_torch_findings.json`` (``--check --json ANALYSIS_torch_findings.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from . import baseline as bl
from .core import DEFAULT_PATHS, AnalysisResult, all_rules, analyze_paths


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static analysis: fixed-point width safety "
                    "(FXP*), PyTorch hot-path hygiene (TOR*), async-serving "
                    "discipline (ASY*).")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/directories to scan (default: {' '.join(DEFAULT_PATHS)})")
    p.add_argument("--root", default=".",
                   help="repo root (baseline + default paths resolve here)")
    p.add_argument("--check", action="store_true",
                   help="gate mode: nonzero exit on any unbaselined finding "
                        "or stale baseline entry")
    p.add_argument("--json", metavar="FILE", default=None,
                   help="write the full findings report as JSON ('-' = stdout)")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help=f"baseline ledger (default: <root>/{bl.DEFAULT_BASELINE} "
                        f"when it exists)")
    p.add_argument("--write-baseline", action="store_true",
                   help="record current findings as the new baseline and exit")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def _report_json(result: AnalysisResult, new_findings, stale, dest: str) -> None:
    payload = {
        "version": 1,
        "files_scanned": result.files_scanned,
        "suppressed": result.suppressed,
        "baselined": len(result.findings) - len(new_findings),
        "stale_baseline_entries": [
            {"rule": e["rule"], "path": e["path"], "message": e["message"]}
            for e in stale],
        "findings": [f.to_dict() for f in new_findings],
    }
    text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    if dest == "-":
        sys.stdout.write(text)
    else:
        with open(dest, "w", encoding="utf-8") as fh:
            fh.write(text)


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name}")
            print(f"        {rule.doc}")
        return 0

    root = os.path.abspath(args.root)
    if not os.path.isdir(root):
        parser.error(f"--root {args.root!r} is not a directory")
    paths = args.paths or [p for p in DEFAULT_PATHS
                           if os.path.exists(os.path.join(root, p))]
    if not paths:
        parser.error("nothing to scan: no paths given and no default paths exist")

    result = analyze_paths(paths, root)

    if args.write_baseline:
        dest = args.baseline or os.path.join(root, bl.DEFAULT_BASELINE)
        with open(dest, "w", encoding="utf-8") as fh:
            fh.write(bl.dump_baseline(result))
        print(f"wrote {len(result.findings)} finding(s) to {dest}")
        return 0

    baseline_path = args.baseline or os.path.join(root, bl.DEFAULT_BASELINE)
    entries: List[dict] = []
    if os.path.exists(baseline_path):
        try:
            entries = bl.load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    new_findings, stale = bl.apply_baseline(result.findings, entries)

    if args.json:
        _report_json(result, new_findings, stale, args.json)

    for f in new_findings:
        print(f.render())
    for e in stale:
        print(f"stale baseline entry: {e['rule']} {e['path']}: {e['message']}")
    n_baselined = len(result.findings) - len(new_findings)
    summary = (f"{result.files_scanned} file(s) scanned: "
               f"{len(new_findings)} finding(s), "
               f"{result.suppressed} suppressed, {n_baselined} baselined")
    if stale:
        summary += f", {len(stale)} stale baseline entr(y/ies)"
    print(summary)

    if new_findings or (args.check and stale):
        return 1
    return 0
