"""Exporters: Prometheus text exposition, JSON snapshots, trace pretty-print.

Counterpart of ``repro.obs.export``, copied as it is (stdlib only).

``prometheus_text`` renders a ``MetricsRegistry`` in the text exposition
format (version 0.0.4) a Prometheus scraper ingests from ``GET /v1/metrics``:

    # HELP ppr_waves_total Waves launched.
    # TYPE ppr_waves_total counter
    ppr_waves_total 5
    ppr_wave_latency_seconds_bucket{le="0.001"} 2
    ...

Mapping choices:

- counters/gauges render 1:1; a gauge's running peak renders as a sibling
  ``<name>_peak`` gauge (Prometheus has no native peak — and the peak *is*
  the point of the admission-queue gauges).
- histograms render canonically (``_bucket``/``_sum``/``_count`` with a
  ``+Inf`` bucket).
- reservoirs render as summaries (``quantile`` series + ``_sum``/``_count``)
  — quantiles come from the bounded sample, sum/count are exact lifetime.

``format_trace`` renders one flight-recorder trace dict as an indented span
tree for terminals (``launch/ppr_run.py --dump-traces``, the HTTP example).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["prometheus_text", "format_trace", "format_event", "format_slo"]

_QUANTILES = (("0.5", 50.0), ("0.95", 95.0), ("0.99", 99.0))


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(pairs) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format (0.0.4)."""
    lines: List[str] = []

    def head(name: str, kind: str, help: str) -> None:
        if help:
            lines.append(f"# HELP {name} {_escape(help)}")
        lines.append(f"# TYPE {name} {kind}")

    for name, kind, help, series in registry.collect():
        if kind == "counter":
            head(name, "counter", help)
            for labels, c in series:
                lines.append(f"{name}{_labels(labels)} {_num(c.value)}")
        elif kind == "gauge":
            head(name, "gauge", help)
            for labels, g in series:
                lines.append(f"{name}{_labels(labels)} {_num(g.value)}")
            head(f"{name}_peak", "gauge", f"Running peak of {name}.")
            for labels, g in series:
                lines.append(f"{name}_peak{_labels(labels)} {_num(g.peak)}")
        elif kind == "histogram":
            head(name, "histogram", help)
            for labels, h in series:
                for le, cum in h.cumulative():
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels(tuple(labels) + (('le', _num(le)),))} "
                        f"{cum}")
                lines.append(f"{name}_sum{_labels(labels)} {_num(h.sum)}")
                lines.append(f"{name}_count{_labels(labels)} {h.count}")
        else:                                               # reservoir
            head(name, "summary", help)
            for labels, r in series:
                for q_label, q in _QUANTILES:
                    lines.append(
                        f"{name}"
                        f"{_labels(tuple(labels) + (('quantile', q_label),))} "
                        f"{_num(r.percentile(q))}")
                lines.append(f"{name}_sum{_labels(labels)} {_num(r.sum)}")
                lines.append(f"{name}_count{_labels(labels)} {r.n_seen}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# human-readable trace dumps
# ---------------------------------------------------------------------------
def _fmt_attrs(attrs: Mapping[str, Any]) -> str:
    if not attrs:
        return ""
    inner = ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in attrs.items())
    return f"  [{inner}]"


def _fmt_span(span: Dict[str, Any], indent: int, lines: List[str]) -> None:
    dur = span.get("duration_s") or 0.0
    lines.append(f"{'  ' * indent}{span['name']:<20s} "
                 f"{dur * 1e3:8.3f} ms{_fmt_attrs(span.get('attrs', {}))}")
    for child in span.get("children", ()):
        _fmt_span(child, indent + 1, lines)


def format_trace(trace: Dict[str, Any]) -> str:
    """One flight-recorder trace dict as an indented span tree."""
    root = trace["root"]
    lines: List[str] = [f"trace {trace['trace_id']} ({trace['kind']})"]
    _fmt_span(root, 1, lines)
    return "\n".join(lines)


def format_event(event: Mapping[str, Any]) -> str:
    """One flight-recorder control-plane event as a single line."""
    extra = {k: v for k, v in event.items() if k not in ("t_s", "kind")}
    return f"t={event['t_s']:.4f}s {event['kind']}{_fmt_attrs(extra)}"


def format_slo(status: Mapping[str, Any]) -> str:
    """An ``SLOMonitor.status()`` dict as a terminal table — one line per
    spec with its state and per-window burn rates."""
    burning = ", ".join(status.get("burning", [])) or "none"
    lines: List[str] = [f"slo status  ({status.get('ticks', 0)} ticks, "
                        f"burning: {burning})"]
    for spec in status.get("specs", ()):
        windows = spec.get("windows", {})
        burns = "  ".join(
            f"{w}s={info.get('burn_rate', 0.0):.2f}"
            for w, info in sorted(windows.items(), key=lambda kv: float(kv[0])))
        lines.append(f"  {spec['name']:<16s} {spec['kind']:<8s} "
                     f"{spec['state']:<8s} {burns}")
    return "\n".join(lines)
