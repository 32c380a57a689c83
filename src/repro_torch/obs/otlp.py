"""OTLP/HTTP JSON exporter — traces and metrics leave the process, stdlib-only.

Counterpart of ``repro.obs.otlp``, copied as it is (stdlib only).  The
wire payloads are byte-identical to the reference's, the instrumentation
scope name (``repro.obs``) and the default ``service.name`` included, so one
collector dashboard reads both packages.

The flight recorder answers "what just happened *here*"; a fleet needs the
same spans and counters in a collector.  This module speaks the
OpenTelemetry Protocol over HTTP/JSON (``POST <endpoint>/v1/traces`` and
``/v1/metrics``) with nothing but ``urllib`` — no OpenTelemetry SDK, no new
runtime dependency, per the repo's no-new-deps rule.

Span path: ``OTLPExporter.record_trace`` is a ``Tracer`` sink.  The service
composes it *beside* the flight recorder via ``repro_torch.obs.trace.fanout_sink``
— export augments the local record, never replaces it.  Completed traces are
converted to OTLP span dicts immediately (no live service objects are
pinned) and held in a bounded queue; ``tick()`` drains the queue in batches.
Span/trace ids derive deterministically from the tracer's monotone trace ids
(32-hex traceId, 16-hex spanId = trace id ⊕ preorder index), so a replayed
run exports byte-identical payloads — the golden snapshot test relies on it.

Metric path: ``tick()`` periodically pushes the registry in **delta
temporality** — counters and histograms report the change since the last
push (a restart-safe stream for a collector), gauges report current value
(plus a ``_peak`` sibling, matching the Prometheus rendering), reservoirs
report as summaries.  Timestamps are the injected clock scaled to
nanoseconds; with the default ``time.monotonic`` they are process-relative,
which OTLP permits for delta streams (collectors align on arrival).

Failure policy: bounded queue (oldest spans dropped past ``queue_capacity``),
``max_retries`` sends with exponential backoff, then the batch is dropped
and counted — the exporter must degrade by losing telemetry, never by
blocking the pump thread indefinitely or growing without bound.  Every
decision is visible: internal counters (``stats()``) are mirrored as
``otlp_*`` families in the bound registry so ``/v1/metrics`` reports on the
exporter itself.
"""
from __future__ import annotations

import json
import time
import urllib.request
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.trace import Span, Trace

__all__ = ["OTLPExporter"]

_QUANTILES = (0.5, 0.95, 0.99)
_ID64 = (1 << 64) - 1
_ID128 = (1 << 128) - 1


def _attr_value(v: Any) -> Dict[str, Any]:
    """One attribute value in OTLP AnyValue JSON (int64 renders as string,
    per the protobuf-JSON mapping; bool checked before int — bool is int)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, (list, tuple)):
        return {"arrayValue": {"values": [_attr_value(x) for x in v]}}
    return {"stringValue": str(v)}


def _attrs(mapping: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [{"key": k, "value": _attr_value(mapping[k])}
            for k in sorted(mapping)]


def _ns(t_s: float) -> str:
    return str(max(0, int(t_s * 1e9)))


def _http_post(url: str, body: bytes, timeout_s: float) -> None:
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        resp.read()


class OTLPExporter:
    """Pushes spans and delta metrics to an OTLP/HTTP collector.

    ``transport`` is the injectable send seam — any
    ``(url, body_bytes) -> None`` raising on failure; the default posts with
    ``urllib``.  ``registry=None`` defers the self-metric mirror to
    ``bind_registry`` (the service binds its telemetry registry).  All time
    comes from ``time_fn``; retries back off via ``sleep_fn`` (both injected
    so tests run instantly and deterministically)."""

    def __init__(self, endpoint: str, *, service_name: str = "repro-ppr",
                 flush_interval_s: float = 5.0, max_batch: int = 128,
                 queue_capacity: int = 2048, max_retries: int = 2,
                 backoff_s: float = 0.05, timeout_s: float = 2.0,
                 transport=None, registry=None, time_fn=time.monotonic,
                 sleep_fn=time.sleep):
        if flush_interval_s <= 0:
            raise ValueError(
                f"flush_interval_s must be > 0, got {flush_interval_s}")
        if max_batch < 1 or queue_capacity < 1:
            raise ValueError(
                f"max_batch/queue_capacity must be >= 1, got "
                f"{max_batch}/{queue_capacity}")
        if max_retries < 0 or backoff_s < 0:
            raise ValueError(
                f"max_retries/backoff_s must be >= 0, got "
                f"{max_retries}/{backoff_s}")
        base = endpoint.rstrip("/")
        self.endpoint = base
        self.traces_url = base + "/v1/traces"
        self.metrics_url = base + "/v1/metrics"
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self.queue_capacity = queue_capacity
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.transport = transport if transport is not None else (
            lambda url, body: _http_post(url, body, self.timeout_s))
        self.time_fn = time_fn
        self.sleep_fn = sleep_fn
        self._spans: Deque[Dict[str, Any]] = deque()
        self._last_push_t: Optional[float] = None
        self._window_start_t = time_fn()
        # delta snapshots: (family, label_key) -> last cumulative state
        self._counter_last: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        self._hist_last: Dict[Tuple[str, Tuple[str, ...]],
                              Tuple[Tuple[int, ...], float, int]] = {}
        # authoritative internal counters (survive a telemetry reset);
        # mirrored as otlp_* families once a registry is bound
        self._counts = {"spans_queued": 0, "spans_exported": 0,
                        "spans_dropped": 0, "span_batches_sent": 0,
                        "metric_pushes": 0, "send_failures": 0,
                        "send_retries": 0}
        self._mirror = None
        if registry is not None:
            self.bind_registry(registry)

    # ------------------------------------------------------------------
    def bind_registry(self, registry) -> None:
        """Mirror the exporter's own counters as ``otlp_*`` families in
        ``registry`` (the service's telemetry registry), so a scrape of
        ``/v1/metrics`` reports on the export pipeline itself."""
        self._mirror = {
            "spans_queued": registry.counter(
                "otlp_spans_queued_total", "Spans accepted from the tracer."),
            "spans_exported": registry.counter(
                "otlp_spans_exported_total", "Spans delivered in sent batches."),
            "spans_dropped": registry.counter(
                "otlp_spans_dropped_total",
                "Spans lost to queue overflow or exhausted retries."),
            "span_batches_sent": registry.counter(
                "otlp_batches_sent_total", "Span batches POSTed."),
            "metric_pushes": registry.counter(
                "otlp_metric_pushes_total", "Delta metric payloads POSTed."),
            "send_failures": registry.counter(
                "otlp_send_failures_total",
                "POSTs that failed after every retry."),
            "send_retries": registry.counter(
                "otlp_send_retries_total", "Individual send attempts retried."),
        }

    def _count(self, key: str, n: int = 1) -> None:
        self._counts[key] += n
        if self._mirror is not None:
            self._mirror[key].get().inc(n)

    def stats(self) -> Dict[str, int]:
        out = dict(self._counts)
        out["queue_depth"] = len(self._spans)
        return out

    # ------------------------------------------------------------------
    # span path (Tracer sink)
    # ------------------------------------------------------------------
    def record_trace(self, trace: Trace) -> None:
        """Tracer sink: convert the completed trace to OTLP spans and queue
        them.  Bounded — past ``queue_capacity`` the *oldest* spans drop
        (fresh telemetry beats stale during an incident)."""
        spans = self._otlp_spans(trace)
        self._count("spans_queued", len(spans))
        self._spans.extend(spans)
        overflow = len(self._spans) - self.queue_capacity
        if overflow > 0:
            for _ in range(overflow):
                self._spans.popleft()
            self._count("spans_dropped", overflow)

    def _otlp_spans(self, trace: Trace) -> List[Dict[str, Any]]:
        trace_hex = f"{trace.trace_id & _ID128:032x}"
        out: List[Dict[str, Any]] = []

        def walk(span: Span, parent_hex: str, index: int) -> int:
            span_hex = f"{((trace.trace_id << 16) | index) & _ID64:016x}"
            attrs = dict(span.attrs)
            if parent_hex == "":
                attrs.setdefault("trace.kind", trace.kind)
            end_s = span.end_s if span.end_s is not None else span.start_s
            rec: Dict[str, Any] = {
                "traceId": trace_hex,
                "spanId": span_hex,
                "name": span.name,
                "kind": 1,                     # SPAN_KIND_INTERNAL
                "startTimeUnixNano": _ns(span.start_s),
                "endTimeUnixNano": _ns(end_s),
                "status": {"code": 0},
            }
            if parent_hex:
                rec["parentSpanId"] = parent_hex
            if attrs:
                rec["attributes"] = _attrs(attrs)
            out.append(rec)
            nxt = index + 1
            for child in span.children:
                nxt = walk(child, span_hex, nxt)
            return nxt

        walk(trace.root, "", 0)
        return out

    def _span_payload(self, spans: List[Dict[str, Any]]) -> Dict[str, Any]:
        return {"resourceSpans": [{
            "resource": {"attributes": _attrs(
                {"service.name": self.service_name})},
            "scopeSpans": [{
                "scope": {"name": "repro.obs", "version": "1"},
                "spans": spans,
            }],
        }]}

    # ------------------------------------------------------------------
    # metric path (delta temporality)
    # ------------------------------------------------------------------
    def _metric_payload(self, registry, now: float) -> Dict[str, Any]:
        start_ns, now_ns = _ns(self._window_start_t), _ns(now)
        metrics: List[Dict[str, Any]] = []
        for name, kind, help_text, series in registry.collect():
            dps_main: List[Dict[str, Any]] = []
            dps_peak: List[Dict[str, Any]] = []
            for labels, inst in series:
                attrs = _attrs(dict(labels))
                lkey = tuple(v for _, v in labels)
                base: Dict[str, Any] = {"timeUnixNano": now_ns}
                if attrs:
                    base["attributes"] = attrs
                if kind == "counter":
                    prev = self._counter_last.get((name, lkey), 0.0)
                    self._counter_last[(name, lkey)] = inst.value
                    dps_main.append({**base, "startTimeUnixNano": start_ns,
                                     "asDouble": inst.value - prev})
                elif kind == "gauge":
                    dps_main.append({**base, "asDouble": inst.value})
                    dps_peak.append({**base, "asDouble": inst.peak})
                elif kind == "histogram":
                    buckets = tuple(inst.bucket_counts)
                    prev_b, prev_sum, prev_n = self._hist_last.get(
                        (name, lkey),
                        ((0,) * len(buckets), 0.0, 0))
                    self._hist_last[(name, lkey)] = \
                        (buckets, inst.sum, inst.count)
                    dps_main.append({
                        **base,
                        "startTimeUnixNano": start_ns,
                        "count": str(inst.count - prev_n),
                        "sum": inst.sum - prev_sum,
                        "bucketCounts": [str(b - p) for b, p
                                         in zip(buckets, prev_b)],
                        "explicitBounds": list(inst.bounds),
                    })
                else:                                       # reservoir
                    dps_main.append({
                        **base,
                        "count": str(inst.n_seen),
                        "sum": inst.sum,
                        "quantileValues": [
                            {"quantile": q,
                             "value": inst.percentile(q * 100.0)}
                            for q in _QUANTILES],
                    })
            entry: Dict[str, Any] = {"name": name}
            if help_text:
                entry["description"] = help_text
            if kind == "counter":
                entry["sum"] = {"dataPoints": dps_main,
                                "aggregationTemporality": 1,  # DELTA
                                "isMonotonic": True}
                metrics.append(entry)
            elif kind == "gauge":
                entry["gauge"] = {"dataPoints": dps_main}
                metrics.append(entry)
                metrics.append({"name": name + "_peak",
                                "description": f"Running peak of {name}.",
                                "gauge": {"dataPoints": dps_peak}})
            elif kind == "histogram":
                entry["histogram"] = {"dataPoints": dps_main,
                                      "aggregationTemporality": 1}
                metrics.append(entry)
            else:
                entry["summary"] = {"dataPoints": dps_main}
                metrics.append(entry)
        return {"resourceMetrics": [{
            "resource": {"attributes": _attrs(
                {"service.name": self.service_name})},
            "scopeMetrics": [{
                "scope": {"name": "repro.obs", "version": "1"},
                "metrics": metrics,
            }],
        }]}

    # ------------------------------------------------------------------
    # sending
    # ------------------------------------------------------------------
    def _send(self, url: str, payload: Dict[str, Any]) -> bool:
        """POST with retry/backoff; True on delivery, False once dropped.
        ``sort_keys`` keeps payload bytes deterministic (golden snapshots)."""
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        for attempt in range(self.max_retries + 1):
            try:
                self.transport(url, body)
                return True
            except Exception:
                if attempt == self.max_retries:
                    break
                self._count("send_retries")
                if self.backoff_s:
                    self.sleep_fn(self.backoff_s * (2 ** attempt))
        self._count("send_failures")
        return False

    def _drain_spans(self) -> int:
        posts = 0
        while self._spans:
            batch = [self._spans.popleft()
                     for _ in range(min(self.max_batch, len(self._spans)))]
            posts += 1
            if self._send(self.traces_url, self._span_payload(batch)):
                self._count("span_batches_sent")
                self._count("spans_exported", len(batch))
            else:
                self._count("spans_dropped", len(batch))
        return posts

    def _push_metrics(self, registry, now: float) -> int:
        payload = self._metric_payload(registry, now)
        delivered = self._send(self.metrics_url, payload)
        if delivered:
            self._count("metric_pushes")
        # the delta window advances either way: a dropped push loses its
        # window (counted above) rather than double-reporting the next one
        self._window_start_t = now
        self._last_push_t = now
        return 1

    # ------------------------------------------------------------------
    def due(self, now: Optional[float] = None) -> bool:
        """True when a periodic metrics push is owed or spans are queued."""
        now = self.time_fn() if now is None else now
        if self._spans:
            return True
        return (self._last_push_t is None or
                now - self._last_push_t >= self.flush_interval_s)

    def tick(self, registry=None, now: Optional[float] = None) -> int:
        """One export cycle: drain queued span batches; push delta metrics
        when the flush interval has elapsed.  Returns POSTs made.  Safe to
        call every pump heartbeat — idle ticks cost two comparisons."""
        now = self.time_fn() if now is None else now
        posts = self._drain_spans()
        if registry is not None and (
                self._last_push_t is None or
                now - self._last_push_t >= self.flush_interval_s):
            posts += self._push_metrics(registry, now)
        return posts

    def flush(self, registry=None, now: Optional[float] = None) -> int:
        """Shutdown/final export: drain every span and force a metrics push
        regardless of the interval."""
        now = self.time_fn() if now is None else now
        posts = self._drain_spans()
        if registry is not None:
            posts += self._push_metrics(registry, now)
        return posts
