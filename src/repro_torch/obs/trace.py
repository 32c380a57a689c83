"""Span-based query tracing with injected clocks.

Counterpart of ``repro.obs.trace``, copied as it is (stdlib only): the
ids and the ``to_dict`` layout are the reference's byte for byte, which the
OTLP golden fixture depends on.

The serving stack's lifetime aggregates can say *that* p95 moved; a trace
says where one query's milliseconds went.  A ``Trace`` is a tree of
``Span``s under one root, carrying the stages a query (or a wave) passes
through:

    query trace:  submit → resolve_precision → cache_probe
                  → admission_wait → wave_execute → (resolved | rejected)
    wave trace:   plan → warm_start → iterate (iterations run, early-exit,
                  residual) → topk → resolve, plus member-trace links

Waves are the unit of compute and queries the unit of latency, so the two
trace kinds cross-link instead of nesting: every member query trace records
its ``wave_trace`` id and the wave trace lists ``member_traces`` — a flight
recorder dump can be re-joined into the full picture after the fact.

Time is injected (``time_fn``) exactly like the scheduler's: tests drive
traces with a fake clock and assert whole span trees deterministically.
The tracer itself holds no history — completed traces go to a sink (the
flight recorder); a tracing-off service simply has no tracer and pays only
an ``is None`` check per instrumentation point.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Trace", "Tracer", "fanout_sink"]


def fanout_sink(*sinks: Callable[["Trace"], None]
                ) -> Callable[["Trace"], None]:
    """Compose tracer sinks: every completed trace goes to each sink in
    order.  The flight recorder stays the first, authoritative sink; an
    exporter rides beside it — export augments the local record, never
    replaces it.  ``None`` entries are skipped so callers can pass optional
    sinks unconditionally."""
    live = tuple(s for s in sinks if s is not None)
    if len(live) == 1:
        return live[0]

    def sink(trace: "Trace") -> None:
        for s in live:
            s(trace)

    return sink


@dataclasses.dataclass
class Span:
    """One timed stage; children are sub-stages."""
    name: str
    start_s: float
    end_s: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return 0.0 if self.end_s is None else self.end_s - self.start_s

    def end(self, t: float, **attrs: Any) -> "Span":
        self.end_s = t
        if attrs:
            self.attrs.update(attrs)
        return self

    def child(self, name: str, t: float, **attrs: Any) -> "Span":
        sp = Span(name, t, attrs=dict(attrs))
        self.children.append(sp)
        return sp

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "start_s": self.start_s,
                               "end_s": self.end_s,
                               "duration_s": self.duration_s}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


@dataclasses.dataclass
class Trace:
    """One query's (or one wave's) span tree plus identity/link attributes."""
    trace_id: int
    kind: str                              # "query" | "wave"
    root: Span
    done: bool = False

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.root.attrs

    def span(self, name: str, t: float, **attrs: Any) -> Span:
        return self.root.child(name, t, **attrs)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "kind": self.kind,
                "root": self.root.to_dict()}


class Tracer:
    """Mints traces against one clock; finished traces flow to ``sink``.

    ``sink`` is any callable taking a completed ``Trace`` — in the service
    it is the flight recorder's ``record_trace``.  Trace ids are a process-
    local monotone counter: unique within a service lifetime, cheap, and
    stable under replay."""

    def __init__(self, time_fn: Callable[[], float] = time.monotonic,
                 sink: Optional[Callable[[Trace], None]] = None):
        self.time_fn = time_fn
        self.sink = sink
        self._ids = itertools.count(1)
        self.started = 0
        self.finished = 0

    def start(self, kind: str, name: str,
              t: Optional[float] = None, **attrs: Any) -> Trace:
        t = self.time_fn() if t is None else t
        self.started += 1
        return Trace(next(self._ids), kind,
                     Span(name, t, attrs=dict(attrs)))

    def finish(self, trace: Trace, t: Optional[float] = None,
               **attrs: Any) -> Trace:
        """End the root span, mark done, hand to the sink.  Idempotent —
        a trace that raced two completion paths records only the first."""
        if trace.done:
            return trace
        trace.root.end(self.time_fn() if t is None else t, **attrs)
        trace.done = True
        self.finished += 1
        if self.sink is not None:
            self.sink(trace)
        return trace
