"""Observability for the serving stack (counterpart of ``repro.obs``).

Stdlib only, and copied from the reference module by module:

``metrics.py``   bounded instruments (Counter/Gauge/Histogram/Reservoir) in
                 a ``MetricsRegistry`` with label support and a series cap —
                 what ``ServiceTelemetry`` stores its state in.
``trace.py``     span-based tracer with injected clocks: a query trace
                 (submit → cache probe → admission wait → wave execute →
                 resolution) cross-linked with a per-wave trace (plan →
                 iterate w/ early-exit residual → top-K → resolve).
``recorder.py``  flight recorder: ring buffers of the last N completed
                 traces and admission-control transitions.
``export.py``    Prometheus text exposition (``GET /v1/metrics``), JSON
                 dumps, and terminal-friendly trace/SLO rendering.
``slo.py``       declarative SLO specs evaluated over sliding windows by an
                 injected-clock ``SLOMonitor`` with multi-window burn-rate
                 alerting.
``otlp.py``      stdlib-only OTLP/HTTP-JSON exporter: spans via a fan-out
                 ``Tracer`` sink beside the flight recorder, metrics via a
                 periodic delta-temporality push.

Nothing here imports torch: the observability layer must never be the thing
that makes the hot path slow or the test suite heavy.
"""
from repro_torch.obs.export import (
    format_event,
    format_slo,
    format_trace,
    prometheus_text,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
    exponential_buckets,
)
from repro_torch.obs.otlp import OTLPExporter
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.slo import SLOMonitor, SLOSpec, default_slo_specs
from repro_torch.obs.trace import Span, Trace, Tracer, fanout_sink

__all__ = [
    "Counter", "Gauge", "Histogram", "Reservoir", "MetricsRegistry",
    "exponential_buckets",
    "Span", "Trace", "Tracer", "fanout_sink",
    "FlightRecorder",
    "SLOSpec", "SLOMonitor", "default_slo_specs",
    "OTLPExporter",
    "prometheus_text", "format_trace", "format_event", "format_slo",
]
