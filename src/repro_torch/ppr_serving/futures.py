"""`PPRFuture` — the async result handle of the futures-based serving API.

``PPRService.submit`` returns one future per query.  A cache hit resolves the
future before ``submit`` even returns; a miss leaves it pending in the wave
scheduler until its wave launches (``poll``/``flush``, or the deadline-aware
admission policy) and the wave's completion resolves every occupant.

The service is single-process and synchronous, so ``result()`` does not block
on another thread — it *drives*: a pending future asks its service to launch
ready waves and, if still unresolved, to flush its own wave key.  ``result``
therefore always returns (or raises) in bounded time; ``timeout=0`` is the
non-blocking probe that raises ``TimeoutError`` instead of driving.

Futures reject instead of dangling: re-registering a graph or an edge delta
whose affected frontier covers a pending query's personalization vertex
rejects that future with a descriptive ``QueryRejected`` — a pending handle
is never silently dropped the way the legacy ``submit() -> None`` contract
allowed.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

__all__ = ["PPRFuture", "QueryRejected"]


class QueryRejected(RuntimeError):
    """A pending query's future can never resolve (graph re-registered, or a
    delta invalidated the query's personalization vertex) — resubmit.

    ``code`` names the rejection class machine-readably so transports can map
    it without parsing the message: ``"graph-replaced"`` (re-registration —
    the HTTP tier serves 410 Gone) or ``"delta-invalidated"`` (epoch bump
    caught the pending vertex in its frontier — HTTP 409 Conflict, resubmit
    against the new topology).  The default ``"rejected"`` covers plug-in
    rejection paths."""

    def __init__(self, message: str, code: str = "rejected"):
        super().__init__(message)
        self.code = code


class PPRFuture:
    """Result handle for one submitted ``PPRQuery``.

    States: *pending* (queued for a wave) → *done* (holding either a
    ``Recommendation`` or an exception).  There is no cancelled state — the
    service rejects futures it cannot serve via ``QueryRejected``.
    """

    __slots__ = ("query", "_service", "_wave_key", "_result", "_exception",
                 "_done", "_callbacks", "_trace")

    def __init__(self, query, service=None):
        self.query = query
        self._service = service
        self._wave_key = None          # scheduler key while pending
        self._trace = None             # live obs trace when tracing is on
        self._result: Optional[Any] = None
        self._exception: Optional[BaseException] = None
        self._done = False
        self._callbacks: List[Callable[["PPRFuture"], None]] = []

    # ------------------------------------------------------------------
    def done(self) -> bool:
        """True once the future holds a result or an exception."""
        return self._done

    def result(self, timeout: Optional[float] = None):
        """The ``Recommendation``; drives the service if still pending.

        ``timeout=0`` never drives: it raises ``TimeoutError`` immediately
        when the future is pending (the non-blocking probe).  Any other
        timeout launches the service's ready waves and, if the future is
        still queued, flushes its wave — resolution is synchronous, so the
        timeout value itself is never waited out.
        """
        self._await(timeout)
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The rejection exception, or None for a successful result.

        Drives the service exactly like ``result`` when pending."""
        self._await(timeout)
        return self._exception

    def _await(self, timeout: Optional[float]) -> None:
        """Shared pending-probe semantics of ``result``/``exception``:
        timeout<=0 is a non-blocking probe, otherwise drive the owning
        service; still-pending afterwards is a ``TimeoutError``."""
        if self._done:
            return
        vertex = getattr(self.query, "vertex", "?")
        if timeout is not None and timeout <= 0:
            raise TimeoutError(
                f"query for vertex {vertex} is still pending "
                f"(timeout=0 never drives the service)")
        if self._service is not None:
            self._service._drive(self)
        if not self._done:
            raise TimeoutError(
                f"query for vertex {vertex} could not be resolved "
                f"(no owning service to drive, or driving it never launched "
                f"this future's wave)")

    def add_done_callback(self, fn: Callable[["PPRFuture"], None]) -> None:
        """Run ``fn(self)`` when the future resolves (immediately if done).

        Callback exceptions are swallowed — a misbehaving callback must not
        poison the wave that is resolving its co-batched futures."""
        if self._done:
            try:
                fn(self)
            except Exception:
                pass
            return
        self._callbacks.append(fn)

    # ------------------------------------------------------------------
    # resolution — called by the owning service only
    def _resolve(self, result) -> None:
        self._result = result
        self._finish()

    def _reject(self, exc: BaseException) -> None:
        self._exception = exc
        self._finish()

    def _finish(self) -> None:
        self._done = True
        self._wave_key = None
        callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if not self._done:
            state = "pending"
        elif self._exception is not None:
            state = f"rejected: {self._exception!r}"
        else:
            state = "done"
        return f"<PPRFuture {getattr(self.query, 'vertex', '?')} {state}>"
