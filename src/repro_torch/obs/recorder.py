"""Flight recorder — the last N completed traces and control-plane events.

Counterpart of ``repro.obs.recorder``, copied as it is (stdlib only).

Lifetime counters say a shed event happened; reconstructing *the incident*
(queue built up → κ deepened → quality degraded → arrivals shed → drained →
recovered, and what the queries in flight experienced meanwhile) needs a
time-resolved record.  The recorder is two ring buffers:

``traces``   the last ``trace_capacity`` completed ``Trace``s (query and
             wave kinds interleaved in completion order), stored as plain
             dicts so a dump is JSON-ready and holds no live object graphs.
``events``   admission-control transitions and other control-plane moments
             (shed engage/recover, SLO degrade/recover, κ moves, deltas,
             graph replacement), each ``{t_s, kind, ...attrs}``.

Both are ``deque(maxlen=...)`` — O(1) memory in queries served, the same
bound the metrics registry enforces.  ``GET /v1/debug/traces`` and
``launch/ppr_run.py --dump-traces`` serve ``snapshot()`` verbatim.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import Trace

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, trace_capacity: int = 256, event_capacity: int = 1024):
        if trace_capacity < 1 or event_capacity < 1:
            raise ValueError(
                f"capacities must be >= 1, got {trace_capacity}/"
                f"{event_capacity}")
        self.trace_capacity = trace_capacity
        self.event_capacity = event_capacity
        self._traces: "deque[Dict[str, Any]]" = deque(maxlen=trace_capacity)
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=event_capacity)
        self.traces_recorded = 0
        self.events_recorded = 0

    # ------------------------------------------------------------------
    def record_trace(self, trace: Trace) -> None:
        """Sink for ``Tracer`` — stores the trace's dict form, so the ring
        never pins service objects (futures, arrays) against GC."""
        self._traces.append(trace.to_dict())
        self.traces_recorded += 1

    def record_event(self, kind: str, t_s: float, **attrs: Any) -> None:
        ev: Dict[str, Any] = {"t_s": float(t_s), "kind": kind}
        ev.update(attrs)
        self._events.append(ev)
        self.events_recorded += 1

    # ------------------------------------------------------------------
    def traces(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The most recent ``n`` completed traces, oldest first."""
        out = list(self._traces)
        return out if n is None else out[-n:]

    def events(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        out = list(self._events)
        return out if n is None else out[-n:]

    def events_of_kind(self, *kinds: str,
                       n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The most recent ``n`` events whose kind is in ``kinds``, oldest
        first — how ``/v1/slo`` pulls just the alert transitions out of the
        shared control-plane ring."""
        out = [ev for ev in self._events if ev["kind"] in kinds]
        return out if n is None else out[-n:]

    def snapshot(self, n_traces: Optional[int] = None,
                 n_events: Optional[int] = None) -> Dict[str, Any]:
        """JSON-ready dump: what ``/v1/debug/traces`` serves."""
        return {
            "trace_capacity": self.trace_capacity,
            "event_capacity": self.event_capacity,
            "traces_recorded": self.traces_recorded,
            "events_recorded": self.events_recorded,
            "traces": self.traces(n_traces),
            "events": self.events(n_events),
        }
