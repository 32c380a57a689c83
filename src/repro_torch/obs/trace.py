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

Beside the trees, a ``Timeline`` records flat host spans of the serving
path (``TIMELINE_SPANS``: submit, admission, each wave's stages, each fused
step or a fixed-budget wave's replay, a fused graph's stream build) for
whole-window profiling, where the trees' dicts and 256-trace ring would
cost too much and their injected clock must not be read.  Its clock is
``time.perf_counter_ns``, the host clock a device trace can be tied to (a
marker kernel launched at a known perf-counter instant), so device
operations can be attributed to the span that launched them.  One
process-wide slot, ``armed``, holds the timeline being recorded: the engine
layer has no handle on the service, and the caller that profiles arms and
disarms it (``arm_timeline`` / ``disarm_timeline``).  Off, each
instrumentation point pays one ``is None`` check.
"""
from __future__ import annotations

import array
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Trace", "Tracer", "fanout_sink", "TIMELINE_SPANS",
           "Timeline", "span_id", "arm_timeline", "disarm_timeline"]


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


# ---------------------------------------------------------------------------
# the flat span timeline
# ---------------------------------------------------------------------------
#: every span a ``Timeline`` records; a record holds the name's index here
TIMELINE_SPANS = (
    "ppr.submit",              # PPRService.submit, the whole call
    "ppr.admit",               # the scheduler's ready_waves/drain/flush_keys
    "ppr.wave",                # _run_wave, the whole call (with its wave id)
    "ppr.wave.plan",           # engine.plan + plan.initial
    "ppr.wave.iterate",        # plan.iterate: the host's enqueue of the steps
    "ppr.step",                # one fused_ppr_iteration call, eager waves only
    "ppr.wave.replay",         # a fixed-budget wave's captured graph: copies, replay, clone
    "ppr.wave.topk",           # plan.topk's enqueue
    "ppr.wave.device_wait",    # the top-K results' copies to the host
    "ppr.wave.resolve",        # recommendations, cache puts, telemetry
    "ppr.wave.callbacks",      # the futures' resolution (callers' callbacks)
    "ppr.graph.stream",        # a fused graph's dst stream built from its COO arrays
)
_SPAN_IDS = {name: i for i, name in enumerate(TIMELINE_SPANS)}


def span_id(name: str) -> int:
    """The record id of ``name``; an unknown name raises (resolve ids once,
    where the module imports, so a typo fails there)."""
    if name not in _SPAN_IDS:
        raise ValueError(f"unknown timeline span {name!r} (have {TIMELINE_SPANS})")
    return _SPAN_IDS[name]


class Timeline:
    """A bounded record of host spans, one row per span in preallocated
    columns: name id, start and end (``time.perf_counter_ns``), wave id (0
    where the recording code knows of no wave: a fused step's wave is its
    parent's) and thread id.

    A span is recorded at its end, its start read at its start: no object,
    no dict and no lock per span (a slot is claimed with one ``next`` on a
    counter, which the interpreter lock makes atomic, so the HTTP pump's
    worker and the event loop record side by side).  Full, it records
    nothing more and counts what it dropped.  A record's parent, found when
    the records are read, is the innermost span of the same thread that
    contains it.  Read it once recording has stopped (``disarm_timeline``):
    ``n`` and ``dropped`` peek at the counter."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.name = array.array("h", bytes(2 * self.capacity))
        self.start = array.array("q", bytes(8 * self.capacity))
        self.end = array.array("q", bytes(8 * self.capacity))
        self.wave = array.array("q", bytes(8 * self.capacity))
        self.thread = array.array("Q", bytes(8 * self.capacity))
        self._slots = itertools.count()

    def record(self, name: int, start_ns: int, end_ns: int, wave: int = 0) -> None:
        """One finished span (``name`` from ``span_id``)."""
        i = next(self._slots)
        if i < self.capacity:
            self.name[i] = name
            self.start[i] = start_ns
            self.end[i] = end_ns
            self.wave[i] = wave
            self.thread[i] = threading.get_ident()

    def _claimed(self) -> int:
        claimed = next(self._slots)
        self._slots = itertools.count(claimed)
        return claimed

    @property
    def n(self) -> int:
        """Records held."""
        return min(self._claimed(), self.capacity)

    @property
    def dropped(self) -> int:
        """Spans that found the timeline full."""
        return max(0, self._claimed() - self.capacity)

    def parents(self) -> List[int]:
        """Each record's parent: the index of the innermost record of its
        thread whose interval contains it, or -1."""
        n = self.n
        order = sorted(range(n), key=lambda i: (self.thread[i], self.start[i],
                                                -self.end[i], -i))
        parent = [-1] * n
        stack: List[int] = []
        thread = None
        for i in order:
            if self.thread[i] != thread:
                thread, stack = self.thread[i], []
            end = self.end[i]
            while stack and self.end[stack[-1]] < end:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
            stack.append(i)
        return parent

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count``, ``total_s`` and ``self_s`` (durations
        less the direct children's)."""
        parents = self.parents()
        n = len(parents)
        child_ns = [0] * n
        for i, p in enumerate(parents):
            if p >= 0:
                child_ns[p] += self.end[i] - self.start[i]
        out: Dict[str, Dict[str, float]] = {}
        for i in range(n):
            s = out.setdefault(TIMELINE_SPANS[self.name[i]],
                               {"count": 0, "total_s": 0.0, "self_s": 0.0})
            d = self.end[i] - self.start[i]
            s["count"] += 1
            s["total_s"] += d / 1e9
            s["self_s"] += (d - child_ns[i]) / 1e9
        return out


#: the timeline being recorded, or None (read once per instrumentation point)
armed: Optional[Timeline] = None


def arm_timeline(capacity: int) -> Timeline:
    """Arm a new timeline of ``capacity`` records in the process-wide slot
    and return it."""
    global armed
    armed = Timeline(capacity)
    return armed


def disarm_timeline() -> Optional[Timeline]:
    """Empty the slot; returns the timeline that was armed (None if none)."""
    global armed
    tl, armed = armed, None
    return tl
