"""Rule pack 1 — fixed-point width safety (FXP...).

Counterpart of ``repro.analysis.fixedpoint``: the same IDs and the same
taint and width passes, keyed on the port's idioms.

The paper's correctness story is that raw Q-format arithmetic never silently
overflows.  In the port a raw Qm.f value lives in an int32 tensor holding
uint32 bits; products go through ``QFormat.mul`` / ``mul_raw`` (two 48-bit
partial products in int64), sums run in int64 (``widen_u32`` or
``.to(torch.int64)``) and wrap back to 32 bits (``wrap_u32``), and raw/float
domains only meet inside the blessed conversion helpers.  These rules make
the conventions checkable:

- **FXP001 raw-accumulation-width** — ``acc.index_add_(dim, index, op)`` /
  ``scatter_add_`` / ``x.sum()`` / ``torch.sum(x)`` over a raw-domain operand
  without an int64 width guard: ``.to(torch.int64)``, ``.long()`` or
  ``widen_u32(...)`` on the operand (followed through single assignments and
  through integer arithmetic such as ``& mask``), an accumulator made with
  ``dtype=torch.int64``, or a ``dtype=torch.int64`` on the sum itself.  An int32 lane is not a guard: it
  is the raw storage type, and a sum of uint32 bits in it is signed.
- **FXP002 shift-discards-bits** — ``x << k`` (constant ``k``) where the
  inferred width of ``x`` plus ``k`` exceeds 32: set bits fall off the top of
  the uint32 lane.  Width inference is interprocedural within a module
  (``_WidthEnv``): a call to a top-level local function resolves to the max
  width of its returns with parameters seeded from the call site.
  Carry-tracked shifts, and shifts of Python ints inside int64 arithmetic,
  suppress this with an ``allow`` comment saying why no bit is lost.
- **FXP003 raw-domain-discipline** — ``*`` between two raw operands outside
  ``QFormat.mul`` / ``mul_raw`` (an int64 product of two 32-bit raws
  overflows; a uint32 one wraps), or arithmetic mixing a raw operand with a
  float literal (scale confusion).

Raw-domain tracking is a per-function taint pass: parameters and locals whose
name contains ``raw`` seed the set; assignment propagates through arithmetic,
subscripts, ``widen_u32`` / ``wrap_u32`` and ``fmt.mul(...)`` /
``mul_raw(...)`` results; ``to_float`` / ``quantize_f32`` and a cast to
float (``.to(torch.float32/float64)``, ``.float()``, ``.double()``,
``.astype(np.float32)``) clear the taint.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from . import _astutil as A
from .core import FileContext, Finding, Rule, register_rule

_INT_GUARDS = {"int64", "i64"}
_FLOAT_CASTS = {"float32", "float64", "f32", "f64", "float", "double"}
# method casts: x.long() / x.float() / x.double()
_CAST_METHODS = {"long": "int64", "float": "float32", "double": "float64"}
_TO_FLOAT_HELPERS = {"to_float", "quantize_f32"}
_RAW_PRODUCERS = {"from_float", "quantize_raw", "mul_raw"}
# raw in, raw out: the int64 widening and the 32-bit wrap keep the domain
_DOMAIN_KEEPERS = {"widen_u32", "wrap_u32"}
_WIDEN = "widen_u32"
# integer ops whose result keeps an int64 operand's lane (true division
# leaves the integer domain)
_INT_LANE_OPS = (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod, ast.BitAnd,
                 ast.BitOr, ast.BitXor, ast.LShift, ast.RShift)
# modules whose reductions take the operand as their first argument
_MODULES = {"torch", "np", "numpy"}


def _name_is_raw(name: str) -> bool:
    return "raw" in name.lower()


def _type_matches(node: ast.AST, type_names: Set[str]) -> bool:
    """``node`` names a dtype whose trailing identifier is in ``type_names``
    (``torch.int64``, ``np.float32``, aliases such as ``_I64``)."""
    name = A.dotted_name(node)
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1].lower().lstrip("_")
    return any(leaf == t or leaf.endswith(t) for t in type_names)


def _is_cast_to(node: ast.AST, type_names: Set[str]) -> bool:
    """True when ``node`` casts to a dtype in ``type_names``:
    ``x.to(t)``, ``x.to(dtype=t)``, ``x.astype(t)`` (host numpy), or the
    method forms ``x.long()`` / ``x.float()`` / ``x.double()``."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr in _CAST_METHODS and not node.args:
        return _CAST_METHODS[attr] in type_names
    if attr == "astype":
        return A.is_astype_to(node, type_names)
    if attr != "to":
        return False
    targets = list(node.args) + [kw.value for kw in node.keywords
                                 if kw.arg == "dtype"]
    return any(_type_matches(t, type_names) for t in targets)


def _has_dtype_kw(node: ast.Call, type_names: Set[str]) -> bool:
    """``f(..., dtype=t)`` with ``t`` in ``type_names``."""
    return any(kw.arg == "dtype" and _type_matches(kw.value, type_names)
               for kw in node.keywords)


def _leaf(node: ast.Call) -> str:
    name = A.call_name(node)
    return name.rsplit(".", 1)[-1] if name else ""


def _raw_vars_for_function(fn: ast.AST) -> Set[str]:
    """One forward pass over the function body collecting raw-tainted locals."""
    raw: Set[str] = {p for p in A.param_names(fn) if _name_is_raw(p)}

    def expr_is_raw(node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            leaf = _leaf(node)
            if leaf in _TO_FLOAT_HELPERS:
                return False
            if leaf in _RAW_PRODUCERS or leaf == "mul":
                return True
            if _is_cast_to(node, _FLOAT_CASTS):
                return False
            if isinstance(node.func, ast.Attribute):
                # .to(int64)/.long()/.sum()/slicing helpers keep the domain
                return expr_is_raw(node.func.value) or any(
                    expr_is_raw(a) for a in node.args)
            return any(expr_is_raw(a) for a in node.args)
        if isinstance(node, ast.Name):
            return node.id in raw or _name_is_raw(node.id)
        if isinstance(node, ast.Attribute):
            return _name_is_raw(node.attr)
        if isinstance(node, ast.BinOp):
            return expr_is_raw(node.left) or expr_is_raw(node.right)
        if isinstance(node, ast.Subscript):
            return expr_is_raw(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(expr_is_raw(e) for e in node.elts)
        return False

    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            if isinstance(tgt, ast.Name):
                if expr_is_raw(stmt.value):
                    raw.add(tgt.id)
                else:
                    raw.discard(tgt.id)
    return raw


class _RawTaint:
    """Raw-domain query helper bound to one function's taint set."""

    def __init__(self, fn: ast.AST):
        self.raw = _raw_vars_for_function(fn)

    def is_raw(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.raw or _name_is_raw(node.id)
        if isinstance(node, ast.Attribute):
            return _name_is_raw(node.attr)
        if isinstance(node, ast.Subscript):
            return self.is_raw(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_raw(node.left) or self.is_raw(node.right)
        if isinstance(node, ast.Call):
            leaf = _leaf(node)
            if leaf in _TO_FLOAT_HELPERS:
                return False
            if leaf in _RAW_PRODUCERS or leaf == "mul":
                return True
            if leaf in _DOMAIN_KEEPERS and node.args:
                return self.is_raw(node.args[0])
            if _is_cast_to(node, _FLOAT_CASTS):
                return False
            if isinstance(node.func, ast.Attribute):
                return self.is_raw(node.func.value)
        return False


class _WidthGuards:
    """Which expressions carry an int64 width guard, with locals followed
    through single assignments (one forward pass, as the taint pass)."""

    def __init__(self, fn: ast.AST):
        self.names: Set[str] = set()
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    if self.guarded(stmt.value):
                        self.names.add(tgt.id)
                    else:
                        self.names.discard(tgt.id)

    def guarded(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.guarded(node.value)
        if isinstance(node, ast.BinOp) and isinstance(node.op, _INT_LANE_OPS):
            # (x.to(torch.int64) & 0xFFFFFFFF), d.long() * widen_u32(P):
            # integer arithmetic with an int64 side stays in the int64 lane
            return self.guarded(node.left) or self.guarded(node.right)
        if isinstance(node, ast.Call):
            if _is_cast_to(node, _INT_GUARDS) or _leaf(node) == _WIDEN:
                return True
            # torch.zeros(..., dtype=torch.int64): an int64 accumulator
            if _has_dtype_kw(node, _INT_GUARDS):
                return True
            # (expr).to(torch.int64).sum(0): the receiver carries the guard
            if isinstance(node.func, ast.Attribute):
                return self.guarded(node.func.value)
        return False


def _accumulation(node: ast.Call):
    """(operand, accumulator) of a raw-sum call, else None.  ``acc`` is the
    tensor summed into (None for a reduction)."""
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    recv = node.func.value
    is_module = A.dotted_name(recv) in _MODULES
    if attr in ("index_add_", "index_add", "scatter_add_", "scatter_add"):
        kw = "src" if attr.startswith("scatter") else "source"
        if is_module:               # torch.index_add(input, dim, index, source)
            args, acc = node.args[1:], node.args[0] if node.args else None
        else:                       # acc.index_add_(dim, index, source)
            args, acc = node.args, recv
        if len(args) >= 3:
            return args[2], acc
        for k in node.keywords:
            if k.arg == kw:
                return k.value, acc
        return None
    if attr == "sum":
        if is_module:
            return (node.args[0], None) if node.args else None
        return recv, None
    return None


@register_rule
class RawAccumulationWidth(Rule):
    id = "FXP001"
    name = "raw-accumulation-width"
    doc = ("Raw-domain accumulation (index_add_ / scatter_add_ / .sum / "
           "torch.sum) without an int64 width guard (.to(torch.int64), "
           ".long(), widen_u32, or an int64 accumulator): sums of uint32 "
           "bits in an int32 lane wrap and read as signed.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        bits = ctx.config.max_format_bits
        for fn in A.func_defs(ctx.tree):
            taint = _RawTaint(fn)
            guards = _WidthGuards(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                found = _accumulation(node)
                if found is None:
                    continue
                op, acc = found
                if not taint.is_raw(op):
                    continue
                if (guards.guarded(op) or _has_dtype_kw(node, _INT_GUARDS)
                        or (acc is not None and guards.guarded(acc))):
                    continue
                yield self.finding(
                    ctx, node,
                    f"raw-domain accumulation without a width guard; "
                    f"registered formats reach {bits} bits — cast the "
                    f"operand with .to(torch.int64) so the sum is exact, "
                    f"or widen the lane")


# -- FXP002: symbolic width inference ---------------------------------------

_WIDTH_UNKNOWN = 32


def _infer_width(node: ast.AST, local_widths: Dict[str, int],
                 env: Optional["_WidthEnv"] = None) -> int:
    """Upper bound on the number of significant bits of ``node`` in a uint32
    lane.  Unknown expressions are assumed full-width (32).  With a
    ``_WidthEnv``, calls to module-local functions resolve to the callee's
    return width (params seeded from the call site's argument widths)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return max(node.value.bit_length(), 1)
    if isinstance(node, ast.Name):
        return local_widths.get(node.id, _WIDTH_UNKNOWN)
    if isinstance(node, ast.Compare):
        return 1
    if isinstance(node, ast.Call):
        # (a < b).astype(u32) — a 0/1 mask keeps width 1
        if isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
            return _infer_width(node.func.value, local_widths, env)
        if env is not None:
            w = env.call_return_width(node, local_widths)
            if w is not None:
                return w
        return _WIDTH_UNKNOWN
    if isinstance(node, ast.BinOp):
        op = node.op
        lw = _infer_width(node.left, local_widths, env)
        rw = _infer_width(node.right, local_widths, env)
        if isinstance(op, ast.BitAnd):
            # masking bounds the result by the narrower side
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) and isinstance(side.value, int):
                    return max(side.value.bit_length(), 1)
            return min(lw, rw)
        if isinstance(op, ast.RShift):
            if isinstance(node.right, ast.Constant) and isinstance(node.right.value, int):
                return max(lw - node.right.value, 0)
            return lw
        if isinstance(op, ast.LShift):
            if isinstance(node.right, ast.Constant) and isinstance(node.right.value, int):
                return lw + node.right.value
            return 64
        if isinstance(op, ast.Mult):
            return lw + rw
        if isinstance(op, (ast.Add, ast.Sub)):
            return max(lw, rw) + 1
        if isinstance(op, (ast.BitOr, ast.BitXor)):
            return max(lw, rw)
    if isinstance(node, ast.Subscript):
        return _infer_width(node.value, local_widths, env)
    return _WIDTH_UNKNOWN


def _own_returns(fn: ast.AST):
    """``return`` expressions belonging to ``fn`` itself (nested defs and
    lambdas have their own return scopes and are not descended into)."""
    rets = []
    stack = list(getattr(fn, "body", []))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Return):
            if n.value is not None:
                rets.append(n.value)
            continue
        stack.extend(ast.iter_child_nodes(n))
    return rets


class _WidthEnv:
    """Cross-function width resolution within one module.

    FXP002's width model is intra-procedural by default; limb helpers like
    ``_fixed_mul_u32`` would otherwise force either blanket suppressions at
    every call site or blind 32-bit assumptions.  This environment resolves a
    call to a *top-level same-module* function by seeding the callee's
    parameters with the call site's inferred argument widths (plus the module
    constants) and taking the max width over the callee's own ``return``
    expressions.  Recursion/cycles and deep chains degrade to unknown
    (``max_depth``), never to a wrong bound.
    """

    max_depth = 4

    def __init__(self, tree: ast.AST, module_widths: Dict[str, int]):
        self.module_widths = module_widths
        self.funcs: Dict[str, ast.FunctionDef] = {
            stmt.name: stmt for stmt in getattr(tree, "body", [])
            if isinstance(stmt, ast.FunctionDef)}
        self._active: list = []

    def _resolve(self, node: ast.Call) -> Optional[ast.FunctionDef]:
        name = A.call_name(node)
        if not name:
            return None
        fn = self.funcs.get(name.rsplit(".", 1)[-1])
        if fn is None or fn.name in self._active \
                or len(self._active) >= self.max_depth:
            return None
        return fn

    @staticmethod
    def _params(fn: ast.FunctionDef):
        return [a.arg for a in fn.args.posonlyargs + fn.args.args]

    def call_return_width(self, node: ast.Call,
                          caller_widths: Dict[str, int]) -> Optional[int]:
        """Max width over the callee's returns, or None when unresolvable."""
        fn = self._resolve(node)
        if fn is None:
            return None
        seed = dict(self.module_widths)
        for p, a in zip(self._params(fn), node.args):
            seed[p] = _infer_width(a, caller_widths, self)
        for kw in node.keywords or []:
            if kw.arg:
                seed[kw.arg] = _infer_width(kw.value, caller_widths, self)
        self._active.append(fn.name)
        try:
            rets = _own_returns(fn)
            if not rets:
                return None
            widths = _local_widths(fn, seed, self)
            return max(_infer_width(r, widths, self) for r in rets)
        finally:
            self._active.pop()

    def call_known(self, node: ast.Call, caller_widths: Dict[str, int]) -> bool:
        """True when every return expression of the callee has a derived
        width, with only the *known* call-site arguments blessing params."""
        fn = self._resolve(node)
        if fn is None:
            return False
        seed = dict(self.module_widths)
        for p, a in zip(self._params(fn), node.args):
            if _width_known(a, caller_widths, self):
                seed[p] = _infer_width(a, caller_widths, self)
        for kw in node.keywords or []:
            if kw.arg and _width_known(kw.value, caller_widths, self):
                seed[kw.arg] = _infer_width(kw.value, caller_widths, self)
        self._active.append(fn.name)
        try:
            rets = _own_returns(fn)
            if not rets:
                return False
            widths = _local_widths(fn, seed, self)
            return all(_width_known(r, widths, self) for r in rets)
        finally:
            self._active.pop()


def _width_known(node: ast.AST, widths: Dict[str, int],
                 env: Optional[_WidthEnv] = None) -> bool:
    """Only flag shifts whose operand width was actually derived.

    Structural recursion replacing the old every-Name-resolved walk: a bare
    Name must have an inferred width (an unresolved one would default to 32
    and spray false positives over arbitrary shifts), a constant mask blesses
    a BitAnd regardless of the other side (the width *is* bounded by the
    mask), and a call to a resolvable module-local function is known iff its
    returns are (``_WidthEnv.call_known``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int)
    if isinstance(node, ast.Name):
        return node.id in widths
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.BitAnd):
            if any(isinstance(s, ast.Constant) and isinstance(s.value, int)
                   for s in (node.left, node.right)):
                return True
        if isinstance(node.op, (ast.RShift, ast.LShift)) \
                and not (isinstance(node.right, ast.Constant)
                         and isinstance(node.right.value, int)):
            # symbolic shift amounts keep the old all-names-resolved demand
            if not _width_known(node.right, widths, env):
                return False
            return _width_known(node.left, widths, env)
        return (_width_known(node.left, widths, env)
                and _width_known(node.right, widths, env))
    if isinstance(node, ast.Subscript):
        return _width_known(node.value, widths, env)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
            return _width_known(node.func.value, widths, env)
        return env is not None and env.call_known(node, widths)
    return False


def _module_const_widths(tree: ast.AST) -> Dict[str, int]:
    """Widths of module-level integer constants, including wrapped ones like
    ``_MASK16 = np.uint32(0xFFFF)`` — the masks the limb code shifts against."""
    widths: Dict[str, int] = {}
    for stmt in getattr(tree, "body", []):
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        value = stmt.value
        if isinstance(value, ast.Call) and len(value.args) == 1:
            value = value.args[0]
        if isinstance(value, ast.Constant) and isinstance(value.value, int):
            widths[stmt.targets[0].id] = max(value.value.bit_length(), 1)
    return widths


def _local_widths(fn: ast.AST, seed: Optional[Dict[str, int]] = None,
                  env: Optional["_WidthEnv"] = None) -> Dict[str, int]:
    """Forward pass recording each single-assignment local's inferred width."""
    widths: Dict[str, int] = dict(seed or {})
    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            if isinstance(tgt, ast.Name):
                widths[tgt.id] = _infer_width(stmt.value, widths, env)
    return widths


@register_rule
class ShiftDiscardsBits(Rule):
    id = "FXP002"
    name = "shift-discards-bits"
    doc = ("x << k where the inferred width of x plus k exceeds the 32-bit "
           "lane: high bits are silently dropped.  Width inference crosses "
           "same-module function boundaries (call-site argument widths seed "
           "the callee).  Carry-tracked shifts must carry an allow comment "
           "naming where the bits are recovered.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        module_widths = _module_const_widths(ctx.tree)
        env = _WidthEnv(ctx.tree, module_widths)
        for fn in A.func_defs(ctx.tree):
            widths = _local_widths(fn, module_widths, env)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.LShift)
                        and isinstance(node.right, ast.Constant)
                        and isinstance(node.right.value, int)):
                    continue
                if not _width_known(node.left, widths, env):
                    continue
                w = _infer_width(node.left, widths, env)
                k = node.right.value
                if w + k > 32:
                    yield self.finding(
                        ctx, node,
                        f"left shift by {k} of a ~{w}-bit value exceeds the "
                        f"32-bit lane; set bits are discarded")


@register_rule
class RawDomainDiscipline(Rule):
    id = "FXP003"
    name = "raw-domain-discipline"
    doc = ("raw*raw multiplication outside QFormat.mul / mul_raw (needs the "
           "split into partial products), or arithmetic mixing a raw operand "
           "with a float literal (scale confusion between domains).")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # fixed_point.py itself hosts the blessed helpers
        blessed_file = ctx.path.endswith("core/fixed_point.py")
        for fn in A.func_defs(ctx.tree):
            taint = _RawTaint(fn)
            blessed_fn = blessed_file or fn.name in (
                _TO_FLOAT_HELPERS | _RAW_PRODUCERS | _DOMAIN_KEEPERS
                | {"mul", "add"})
            for node in ast.walk(fn):
                if not isinstance(node, ast.BinOp):
                    continue
                if isinstance(node.op, ast.Mult) and not blessed_fn:
                    if taint.is_raw(node.left) and taint.is_raw(node.right):
                        yield self.finding(
                            ctx, node,
                            "raw*raw product outside QFormat.mul — a plain "
                            "uint32 multiply wraps; use fmt.mul (16-bit limb "
                            "decomposition) or document exactness")
                        continue
                if isinstance(node.op, (ast.Mult, ast.Add, ast.Sub, ast.Div)):
                    sides = (node.left, node.right)
                    raw_side = any(taint.is_raw(s) for s in sides)
                    float_side = any(
                        isinstance(s, ast.Constant) and isinstance(s.value, float)
                        for s in sides)
                    if raw_side and float_side:
                        yield self.finding(
                            ctx, node,
                            "raw-domain operand mixed with a float literal — "
                            "convert through to_float/from_float instead of "
                            "mixing scales in one expression")
