"""Small AST helpers shared by the rule packs (stdlib only).

Counterpart of ``repro.analysis._astutil``, copied (framework-neutral), less
the two helpers no rule of the port calls (``names_in``, ``const_str_tuple``).
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """Dotted name of the called object ("time.sleep", "self.service.poll")."""
    return dotted_name(node.func)


def func_defs(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def direct_child_defs(fn: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(fn):
        if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def is_astype_to(node: ast.AST, type_names: Set[str]) -> bool:
    """True when ``node`` is ``<expr>.astype(<t>)`` with ``t``'s trailing
    identifier in ``type_names`` (matches ``jnp.int32``, ``np.int64``, bare
    ``int32`` aliases such as ``_I32``)."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "astype" and node.args):
        return False
    t = node.args[0]
    name = dotted_name(t)
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1].lower().lstrip("_")
    return any(leaf == t or leaf.endswith(t) for t in type_names)
