"""Rule pack 3 — async-serving discipline (ASY...).

Counterpart of ``repro.analysis.async_serving``, copied: the port's HTTP tier
(``ppr_serving/http/``) is a copy of the reference's, so the rules apply as
they are.

The HTTP tier runs one asyncio event loop; anything that blocks inside an
``async def`` freezes admission, health checks, and every in-flight request
for the duration (ROADMAP item 3's "blocking inside the pump tick" seam).
These rules fire only inside ``async def`` bodies:

- **ASY301 blocking-call-in-async** — ``time.sleep``, blocking socket /
  subprocess / requests calls.  Use ``await asyncio.sleep`` or offload via
  ``loop.run_in_executor``.
- **ASY302 blocking-future-result** — ``<fut>.result()`` without a
  ``timeout=`` argument: ``PPRFuture.result()`` *drives the service
  synchronously* until resolution, and ``concurrent.futures`` results park
  the loop thread.  Pass ``timeout=0`` for a probe or bridge through an
  asyncio future.
- **ASY303 sync-service-call-in-async** — a direct ``service.poll()`` /
  ``flush()`` / ``run_batch()`` / ``serve()`` / ``drain()`` call: each runs
  whole engine waves on the caller's thread.  Offload to an executor so
  arrivals are admitted *during* compute.
- **ASY304 future-leak** — a ``submit(...)`` result discarded as a bare
  expression statement: nothing can ever resolve, time out, or observe that
  future, so its query silently vanishes on the exception path.
"""
from __future__ import annotations

import ast
from typing import Iterator

from . import _astutil as A
from .core import FileContext, Finding, Rule, register_rule

_BLOCKING_CALLS = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "socket.create_connection": "use asyncio streams / run_in_executor",
    "subprocess.run": "use asyncio.create_subprocess_exec",
    "subprocess.call": "use asyncio.create_subprocess_exec",
    "subprocess.check_call": "use asyncio.create_subprocess_exec",
    "subprocess.check_output": "use asyncio.create_subprocess_exec",
    "requests.get": "offload via run_in_executor",
    "requests.post": "offload via run_in_executor",
    "urllib.request.urlopen": "offload via run_in_executor",
}
_BLOCKING_METHOD_LEAVES = {"accept", "recv", "recv_into", "sendall", "makefile"}
_SERVICE_CALLS = {"poll", "flush", "run_batch", "serve", "drain", "pump"}
_SERVICE_RECEIVERS = {"service", "svc", "_service"}


def _async_defs(ctx: FileContext) -> Iterator[ast.AsyncFunctionDef]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk without descending into nested (sync or async) defs — a nested
    sync helper runs wherever it is *called*, not where it is defined."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _receiver_is_service(node: ast.AST) -> bool:
    """True for attribute chains ending in a service-ish name
    (``self.service``, ``svc``, ``app._service``)."""
    name = A.dotted_name(node)
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1]
    return leaf in _SERVICE_RECEIVERS


@register_rule
class BlockingCallInAsync(Rule):
    id = "ASY301"
    name = "blocking-call-in-async"
    doc = ("time.sleep / blocking socket / subprocess / HTTP calls inside "
           "`async def` park the whole event loop.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _async_defs(ctx):
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = A.call_name(node)
                if not name:
                    continue
                if name in _BLOCKING_CALLS or name.rsplit(".", 1)[-1] == "sleep" \
                        and name.split(".", 1)[0] == "time":
                    hint = _BLOCKING_CALLS.get(name, "offload via run_in_executor")
                    yield self.finding(
                        ctx, node,
                        f"blocking call {name}() inside async def "
                        f"`{fn.name}` parks the event loop; {hint}")


@register_rule
class BlockingFutureResult(Rule):
    id = "ASY302"
    name = "blocking-future-result"
    doc = (".result() without timeout= inside `async def`: PPRFuture.result() "
           "drives the service synchronously until resolution.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _async_defs(ctx):
            for node in _own_nodes(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "result"):
                    continue
                if any(kw.arg == "timeout" for kw in node.keywords) or node.args:
                    continue
                yield self.finding(
                    ctx, node,
                    f".result() without timeout= inside async def "
                    f"`{fn.name}` blocks the loop until the future "
                    f"resolves; pass timeout=0 to probe or await an "
                    f"asyncio bridge")


@register_rule
class SyncServiceCallInAsync(Rule):
    id = "ASY303"
    name = "sync-service-call-in-async"
    doc = ("Direct service.poll()/flush()/run_batch()/serve()/drain() inside "
           "`async def` runs engine waves on the loop thread — offload to an "
           "executor so arrivals are admitted during compute.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _async_defs(ctx):
            for node in _own_nodes(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SERVICE_CALLS):
                    continue
                if _receiver_is_service(node.func.value):
                    yield self.finding(
                        ctx, node,
                        f"synchronous service.{node.func.attr}() inside "
                        f"async def `{fn.name}` blocks the event loop for "
                        f"the full wave; offload via "
                        f"loop.run_in_executor(...)")


@register_rule
class FutureLeak(Rule):
    id = "ASY304"
    name = "future-leak"
    doc = ("A submit(...) result discarded as a bare statement inside "
           "`async def`: the returned future can never be awaited, resolved, "
           "or timed out — its query vanishes on the exception path.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _async_defs(ctx):
            for node in _own_nodes(fn):
                if not (isinstance(node, ast.Expr)
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Attribute)
                        and node.value.func.attr == "submit"):
                    continue
                yield self.finding(
                    ctx, node,
                    f"submit() result discarded inside async def "
                    f"`{fn.name}` — hold the returned future so it can be "
                    f"resolved or cancelled on every exit path")
