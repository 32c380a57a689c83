"""Core machinery for the port's static-analysis suite.

Counterpart of ``repro.analysis.core``: the same findings, registry,
suppression and hot-marker semantics, over the port's tree.  Everything here
is stdlib-only (``ast`` + ``tokenize``): the analyzer must run in CI
containers with no extra dependencies.  The moving parts:

- :class:`Finding` — one diagnostic, sortable and JSON-serializable.
- :class:`Rule` + :func:`register_rule` — the rule registry.  Rule packs
  (``fixedpoint``, ``torch_hygiene``, ``async_serving``) register themselves
  on import; :func:`all_rules` imports them lazily so ``core`` has no cycles.
- :class:`FileContext` — a parsed file plus the comment-derived side tables:
  inline suppressions (``# repro: allow[RULE-ID] reason``) and hot-path
  markers (``# repro: hot-path``).
- :func:`analyze_paths` — the entry point: walk files, run rules, drop suppressed
  findings, return the rest deterministically sorted.

Suppression semantics: an ``allow`` comment applies to findings of that rule
on the comment's own line or, when the comment sits alone on a line, on the
next line.  A suppression **must** carry a non-empty reason; a bare
``# repro: allow[FXP002]`` does not suppress anything and is itself reported
(rule ``SUP000``), so every silenced finding documents why it is safe.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([A-Z]{3}\d{3})\]\s*(.*)")
HOT_PATH_RE = re.compile(r"#\s*repro:\s*hot-path\b")

DEFAULT_PATHS = ("src/repro_torch", "examples_torch")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic.  Ordering is (path, line, col, rule) so output and the
    JSON report are deterministic across runs."""
    path: str                  # repo-relative, '/'-separated
    line: int
    col: int
    rule_id: str
    message: str

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}"

    def baseline_key(self) -> Tuple[str, str, str]:
        """Line-insensitive identity used for baseline matching, so a
        baseline survives unrelated edits above the finding."""
        return (self.rule_id, self.path, self.message)


class Rule:
    """Base class for a checker.  Subclasses set ``id``/``name``/``doc`` and
    implement :meth:`check` yielding findings for one parsed file."""

    id: str = ""
    name: str = ""
    doc: str = ""

    def check(self, ctx: "FileContext") -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST, message: str) -> Finding:
        return Finding(
            path=ctx.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule_id=self.id,
            message=message,
        )


_REGISTRY: Dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: instantiate and register a :class:`Rule`."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> List[Rule]:
    """All registered rules, importing the rule packs on first use."""
    from . import async_serving, fixedpoint, torch_hygiene  # noqa: F401
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Optional[Rule]:
    all_rules()
    return _REGISTRY.get(rule_id)


@dataclasses.dataclass
class AnalysisConfig:
    """Repo-derived facts the rules consult.

    ``max_format_bits`` is parsed out of the port's ``core/fixed_point.py``
    AST (the widest registered ``QFormat``), so the width-safety rules track
    the port's actual precision ladder instead of hard-coding 26."""
    root: str = "."
    max_format_bits: int = 26


def load_config(root: str) -> AnalysisConfig:
    cfg = AnalysisConfig(root=root)
    fp = os.path.join(root, "src", "repro_torch", "core", "fixed_point.py")
    try:
        with open(fp, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return cfg
    widths: List[int] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "QFormat"
            and len(node.args) >= 2
            and all(isinstance(a, ast.Constant) and isinstance(a.value, int)
                    for a in node.args[:2])
        ):
            widths.append(node.args[0].value + node.args[1].value)
    if widths:
        cfg.max_format_bits = max(widths)
    return cfg


@dataclasses.dataclass
class Suppression:
    rule_id: str
    reason: str
    line: int          # line the comment sits on
    comment_only: bool # comment is alone on its line => applies to next line
    used: bool = False


class FileContext:
    """A parsed source file plus its comment side tables."""

    def __init__(self, path: str, source: str, tree: ast.AST,
                 config: AnalysisConfig):
        self.path = path
        self.source = source
        self.tree = tree
        self.config = config
        self.lines = source.splitlines()
        self.suppressions: List[Suppression] = []
        self.bare_allows: List[Tuple[int, str]] = []  # (line, rule_id) sans reason
        self.hot_lines: Set[int] = set()
        self._scan_comments()

    @classmethod
    def parse(cls, abs_path: str, rel_path: str,
              config: AnalysisConfig) -> Optional["FileContext"]:
        try:
            with open(abs_path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel_path)
        except (OSError, SyntaxError, ValueError):
            return None
        return cls(rel_path, source, tree, config)

    def _scan_comments(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(self.source).readline))
        except tokenize.TokenizeError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            text = tok.string
            if HOT_PATH_RE.search(text):
                self.hot_lines.add(line)
            m = ALLOW_RE.search(text)
            if m:
                rule_id, reason = m.group(1), m.group(2).strip()
                comment_only = self.lines[line - 1].lstrip().startswith("#")
                if reason:
                    self.suppressions.append(
                        Suppression(rule_id, reason, line, comment_only))
                else:
                    self.bare_allows.append((line, rule_id))

    # -- suppression lookup -------------------------------------------------
    def suppression_for(self, finding: Finding) -> Optional[Suppression]:
        for sup in self.suppressions:
            if sup.rule_id != finding.rule_id:
                continue
            target = sup.line + 1 if sup.comment_only else sup.line
            if finding.line in (sup.line, target):
                return sup
        return None

    # -- hot-path markers ---------------------------------------------------
    def is_marked_hot(self, fn: ast.AST) -> bool:
        """A ``def`` is marked hot when ``# repro: hot-path`` sits on the def
        line, a decorator line, or the line directly above."""
        first = min([fn.lineno] + [d.lineno for d in getattr(fn, "decorator_list", [])])
        candidates = set(range(first - 1, getattr(fn, "body", [fn])[0].lineno))
        candidates.add(fn.lineno)
        return bool(candidates & self.hot_lines)


def iter_python_files(paths: Sequence[str], root: str) -> Iterator[Tuple[str, str]]:
    """Yield (abs_path, repo_relative_path) for every .py under ``paths``."""
    seen: Set[str] = set()
    for p in paths:
        abs_p = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(abs_p):
            files = [abs_p]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(abs_p):
                dirnames.sort()
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(f, root).replace(os.sep, "/")
            if rel in seen:
                continue
            seen.add(rel)
            yield f, rel


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: int
    files_scanned: int


class _BareAllowRule(Rule):
    id = "SUP000"
    name = "suppression-missing-reason"
    doc = ("`# repro: allow[...]` without a reason does not suppress anything; "
           "every silenced finding must say why it is safe.")


_BARE_ALLOW = _BareAllowRule()


def analyze_paths(paths: Sequence[str], root: str,
                  rules: Optional[Sequence[Rule]] = None) -> AnalysisResult:
    config = load_config(root)
    rules = list(all_rules()) if rules is None else list(rules)
    findings: List[Finding] = []
    suppressed = 0
    n_files = 0
    for abs_path, rel_path in iter_python_files(paths, root):
        ctx = FileContext.parse(abs_path, rel_path, config)
        if ctx is None:
            continue
        n_files += 1
        for line, rule_id in ctx.bare_allows:
            findings.append(Finding(
                path=rel_path, line=line, col=1, rule_id=_BARE_ALLOW.id,
                message=f"allow[{rule_id}] has no reason; suppression ignored"))
        for rule in rules:
            for finding in rule.check(ctx):
                sup = ctx.suppression_for(finding)
                if sup is not None:
                    sup.used = True
                    suppressed += 1
                else:
                    findings.append(finding)
    findings = sorted(set(findings))  # overlapping hot contexts may double-report
    return AnalysisResult(findings=findings, suppressed=suppressed,
                         files_scanned=n_files)


def findings_to_json(result: AnalysisResult) -> str:
    payload = {
        "version": 1,
        "files_scanned": result.files_scanned,
        "suppressed": result.suppressed,
        "findings": [f.to_dict() for f in result.findings],
    }
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"
