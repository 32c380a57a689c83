"""Rule pack 2 — PyTorch hot-path hygiene (TOR...).

Takes the place of ``repro.analysis.jax_hygiene`` (JAX101–103), one rule for
one, under new IDs so that no finding of the port reads as a JAX finding.

Wave latency is the denominator of every queries/s number this repo reports,
and one stray device→host read inside a step body stalls the host until the
card has drained its queue, so the next launches cannot be enqueued ahead of
it.  These rules police the *hot context*: any function marked with a
``# repro: hot-path`` comment on or above its ``def`` (the port runs eagerly
and has no ``jit`` decorator to key on; the markers sit on the counterparts
of the reference's jitted functions).  Nested ``def``s inherit the hot
context.  Telemetry and debug code outside marked functions is exempt by
construction.

- **TOR101 implicit-sync** — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()``, or ``float()`` / ``int()`` / ``bool()`` on a tensor value in
  a hot context: each one is a device→host read that waits for the device.
- **TOR102 host-numpy-on-tensor** — ``np.*`` applied to a tensor value:
  pulls the tensor to host memory.
- **TOR103 tensor-control-flow** — a Python ``if`` / ``while`` whose test is
  a tensor value.  In eager PyTorch this is an implicit ``bool()``, a sync
  and not a retrace, so unlike JAX103 it fires in every hot context.

Taint: a hot function's parameters are tensor values, **except** ``self``,
``cls`` and parameters annotated with a host scalar type (``int``,
``float``, ``bool``, ``str``) — the port's counterpart of the reference's
``static_argnames``.  Metadata clears the taint, as none of it reads the
device: ``.shape`` / ``.dtype`` / ``.ndim`` / ``.device``, ``.size()`` /
``.dim()`` / ``.numel()``, ``len()``, and an ``is None`` test.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from . import _astutil as A
from .core import FileContext, Finding, Rule, register_rule

_STATIC_ATTRS = {"shape", "dtype", "ndim", "device"}
_STATIC_METHODS = {"size", "dim", "numel"}
_HOST_SCALARS = {"int", "float", "bool", "str"}
_SYNC_CASTS = {"float", "int", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NUMPY_ALIASES = {"np", "onp", "numpy"}


def _tensor_params(fn: ast.AST) -> Set[str]:
    """Parameters that hold tensors: all but ``self``/``cls`` and those
    annotated with a host scalar type."""
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    params += [p for p in (a.vararg, a.kwarg) if p is not None]
    return {p.arg for p in params
            if p.arg not in ("self", "cls")
            and not (isinstance(p.annotation, ast.Name)
                     and p.annotation.id in _HOST_SCALARS)}


def _hot_functions(ctx: FileContext) -> Iterator[Tuple[ast.AST, Set[str]]]:
    """Yield (fn, tensor_param_names) for every hot-context function,
    including nested defs, which inherit hotness."""
    for fn in A.func_defs(ctx.tree):
        if not ctx.is_marked_hot(fn):
            continue
        yield fn, _tensor_params(fn)
        for sub in A.direct_child_defs(fn):
            yield sub, _tensor_params(sub)


class _TensorTaint:
    """Forward-pass taint over one function body."""

    def __init__(self, fn: ast.AST, tensor_params: Set[str]):
        self.tainted: Set[str] = set(tensor_params)
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    if self.is_tainted(stmt.value):
                        self.tainted.add(tgt.id)
                    else:
                        self.tainted.discard(tgt.id)
                elif isinstance(tgt, ast.Tuple) and self.is_tainted(stmt.value):
                    for elt in tgt.elts:
                        if isinstance(elt, ast.Name):
                            self.tainted.add(elt.id)

    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is a host structure test
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self.is_tainted(node.left)
                    or any(self.is_tainted(c) for c in node.comparators))
        if isinstance(node, ast.Call):
            name = A.call_name(node)
            if name and name.rsplit(".", 1)[-1] == "len":
                return False  # host metadata
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _STATIC_METHODS:
                    return False  # x.size(), x.numel(): host metadata
                if self.is_tainted(node.func.value):
                    return True
            return any(self.is_tainted(a) for a in node.args) or any(
                self.is_tainted(kw.value) for kw in node.keywords)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return (self.is_tainted(node.body) or self.is_tainted(node.orelse))
        return False


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk ``fn`` without descending into nested defs (those get their own
    taint pass)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@register_rule
class ImplicitSync(Rule):
    id = "TOR101"
    name = "implicit-sync"
    doc = (".item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() on a "
           "tensor inside a hot context — a device->host read that waits for "
           "the device and stalls the launch queue.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn, params in _hot_functions(ctx):
            taint = _TensorTaint(fn, params)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = A.call_name(node)
                leaf = name.rsplit(".", 1)[-1] if name else ""
                if (isinstance(node.func, ast.Name)
                        and node.func.id in _SYNC_CASTS and node.args
                        and taint.is_tainted(node.args[0])):
                    yield self.finding(
                        ctx, node,
                        f"{node.func.id}() on a tensor forces a device sync "
                        f"in the hot path; keep it on device or move it out "
                        f"of the hot context")
                elif (isinstance(node.func, ast.Attribute)
                      and leaf in _SYNC_METHODS
                      and taint.is_tainted(node.func.value)):
                    yield self.finding(
                        ctx, node,
                        f".{leaf}() on a tensor forces a device sync in the "
                        f"hot path")


@register_rule
class HostNumpyOnTensor(Rule):
    id = "TOR102"
    name = "host-numpy-on-tensor"
    doc = ("np.* applied to a tensor inside a hot context — pulls the tensor "
           "to host memory; use the torch equivalent instead.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn, params in _hot_functions(ctx):
            taint = _TensorTaint(fn, params)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = A.call_name(node)
                if not name or "." not in name:
                    continue
                head = name.split(".", 1)[0]
                if head in _NUMPY_ALIASES and any(
                        taint.is_tainted(a) for a in node.args):
                    yield self.finding(
                        ctx, node,
                        f"{name}() on a tensor runs on host — use the torch "
                        f"equivalent to stay on device")


@register_rule
class TensorControlFlow(Rule):
    id = "TOR103"
    name = "tensor-control-flow"
    doc = ("Python if/while on a tensor inside a hot context — an implicit "
           "bool() that syncs with the device; use torch.where or keep the "
           "decision on the host.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn, params in _hot_functions(ctx):
            taint = _TensorTaint(fn, params)
            for node in _own_nodes(fn):
                if isinstance(node, (ast.If, ast.While)) and taint.is_tainted(node.test):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield self.finding(
                        ctx, node,
                        f"Python `{kind}` on a tensor is an implicit bool() "
                        f"that syncs with the device — use torch.where or "
                        f"decide on the host")
