"""Observability for the serving stack (counterpart of ``repro.obs``).

Stdlib only.  This slice carries the metrics registry and the flight
recorder; tracing, SLO burn rates and the OTLP exporter come with the
observability slice.
"""
from repro_torch.obs.metrics import MetricsRegistry, exponential_buckets
from repro_torch.obs.recorder import FlightRecorder

__all__ = ["MetricsRegistry", "exponential_buckets", "FlightRecorder"]
