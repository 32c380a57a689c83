"""Port parity, observability: ``repro_torch.obs`` (tracer, flight recorder,
Prometheus export, SLO monitor, OTLP exporter) and the traced service
against the JAX reference.

The observability modules are host code copied from the reference, so every
scripted scenario below runs through both packages and must produce equal
output: trace dicts, rendered text and Prometheus bytes exactly, SLO states
and burn rates exactly (the same float operations in the same order), the
OTLP wire payloads byte-equal to ``tests/otlp_golden.json`` and the metric
families equal to ``tests/metric_names.txt`` (both read, never written).

The traced service runs on the port's "single" and "fused" families (plain
PyTorch on the CPU) against the reference's "single" and "pallas" (its kernel
in interpret mode) families, over the V = 641 fixture of
``tests/test_pallas_engine.py`` with the same clock: the trace trees, the
head-sampled sets and the recorder events are equal, engine names mapped
("pallas_*" → "fused_*") and the iterate span's ``residual`` held at rtol
1e-5 (the port's fused residual is the kernel's Σd² row, summed in float32
in its own order), plus atol 1e-9 on float32 waves (``_residuals_close``);
the traced answers equal the untraced ones exactly and the reference's
(fixed point raw-bit equal, float32 within 1e-6).
"""
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")

from repro import obs as robs  # noqa: E402
from repro.autotune.convergence import ConvergencePolicy as RPolicy  # noqa: E402
from repro.core.coo import COOGraph  # noqa: E402
from repro.graph_updates import EdgeDelta as REdgeDelta  # noqa: E402
from repro.obs import slo as rslo  # noqa: E402
from repro.ppr_serving import PPRQuery as RQuery  # noqa: E402
from repro.ppr_serving import PPRService as RService  # noqa: E402
from repro.ppr_serving.telemetry import ServiceTelemetry as RTelemetry  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.autotune.convergence import ConvergencePolicy as TPolicy  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.graph_updates import EdgeDelta as TEdgeDelta  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.ppr_serving import PPRQuery as TQuery  # noqa: E402
from repro_torch.ppr_serving import PPRService as TService  # noqa: E402
from repro_torch.ppr_serving.telemetry import ServiceTelemetry as TTelemetry  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_metric_names  # noqa: E402
import test_otlp  # noqa: E402

REF = SimpleNamespace(obs=robs, slo=rslo, Telemetry=RTelemetry)
PORT = SimpleNamespace(obs=tobs, slo=tslo, Telemetry=TTelemetry)
V_PRIME = 641
CPU = "cpu"


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class TickingClock:
    """Every read advances the clock by ``step``: two services that read it
    in the same order see the same times."""

    def __init__(self, step=0.001):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return round(self.t, 6)


def _both(scenario):
    want, got = scenario(REF), scenario(PORT)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# tracer, flight recorder, rendering
# ---------------------------------------------------------------------------
def _tracer_scenario(ns):
    clk = FakeClock()
    rec = ns.obs.FlightRecorder(trace_capacity=4, event_capacity=3)
    seen = []
    tracer = ns.obs.Tracer(time_fn=clk, sink=ns.obs.fanout_sink(
        rec.record_trace, None, lambda tr: seen.append(tr.trace_id)))
    dicts = []
    for i in range(6):
        tr = tracer.start("query" if i % 2 else "wave", "root", vertex=i,
                          member_traces=[i, i + 1])
        clk.t += 0.5
        sp = tr.span("stage", clk(), k=i)
        sp.child("inner", clk() + 0.125, x=1.5).end(clk() + 0.25, y="q")
        sp.end(clk() + 0.375)
        tr.span("open", clk())                      # never ended
        clk.t += 1.0
        tracer.finish(tr, outcome="resolved", scores=(0.5, 0.25))
        tracer.finish(tr, outcome="again")          # idempotent
        dicts.append(tr.to_dict())
        rec.record_event("kappa", clk(), kappa=4 << i, deepened=True)
    snap = rec.snapshot(n_traces=3, n_events=2)
    return {"dicts": dicts, "snapshot": snap, "sunk": seen,
            "counts": (tracer.started, tracer.finished,
                       rec.traces_recorded, rec.events_recorded),
            "kinds": rec.events_of_kind("kappa", n=1),
            "text": [ns.obs.format_trace(d) for d in dicts]
            + [ns.obs.format_event(e) for e in rec.events()]}


def test_tracer_and_recorder_dicts_equal_reference():
    got = _both(_tracer_scenario)
    assert got["counts"] == (6, 6, 6, 6)
    assert len(got["snapshot"]["traces"]) == 3
    assert got["dicts"][0]["root"]["children"][1]["end_s"] is None


def _telemetry_scenario(ns):
    """One scripted traffic history through ``ServiceTelemetry``'s recorders
    (every family), then the registry's exposition and JSON dump."""
    t = ns.Telemetry(reservoir_size=8)
    rng = np.random.default_rng(3)
    for w in range(12):
        pkey = ("f32", "Q1.19", "Q1.25")[w % 3]
        t.record_wave(1 + w % 4, 4, float(rng.random() * 0.01), pkey,
                      engine=("fused_float", "fused_fixed")[w % 2],
                      graph=("a", "b")[w % 2])
        for stage in ("plan", "warm_start", "iterate", "topk", "resolve"):
            t.record_stage(stage, float(rng.random() * 1e-3))
        t.record_admission_wait(float(rng.random() * 0.02))
        t.record_wave_iterations(int(rng.integers(2, 11)))
        t.record_cache(bool(w % 2))
        t.record_query_vertex(("a", "b")[w % 2], int(rng.integers(0, 50)),
                              k=10, pkey=pkey)
        t.record_query_latency(("a", "b")[w % 2], float(rng.random() * 0.05))
        t.record_queue_depth(int(rng.integers(0, 40)), float(rng.random()))
    t.record_auto_resolution("Q1.19")
    t.record_shadow(0.97)
    t.record_shadow(0.61)
    t.record_early_exit(3)
    t.record_delta(16, 8, 3, 5, 1)
    t.record_warm_start(2, 4)
    t.record_prefetch(5)
    t.record_prefetch_suppressed()
    t.record_shed(graph="a")
    t.record_shed()
    t.record_deadline_shed(graph="b")
    t.record_slo_advisory("deepen")
    t.record_shed_transition(engaged=True)
    t.record_slo_transition(degraded=True)
    t.record_degraded_query(graph="a")
    t.record_kappa_change(deepened=True)
    t.record_kappa_change(deepened=False)
    return {"prometheus": ns.obs.prometheus_text(t.registry),
            "json": t.registry.as_dict(), "summary": t.summary()}


def test_prometheus_text_byte_equal_after_scripted_telemetry():
    got = _both(_telemetry_scenario)
    assert "ppr_waves_total 12" in got["prometheus"]


# ---------------------------------------------------------------------------
# SLO monitor: tests/test_slo.py's scenarios through both packages
# ---------------------------------------------------------------------------
FAST, SLOW = (5.0, 30.0), (30.0, 120.0)


def _spec(ns, kind="latency", **kw):
    kw.setdefault("name", f"{kind}_slo")
    kw.setdefault("fast_windows", FAST)
    kw.setdefault("slow_windows", SLOW)
    if kind == "latency":
        kw.setdefault("objective", 0.001024)
    if kind == "quality":
        kw.setdefault("objective", 0.90)
    kw.setdefault("budget", 0.05)
    return ns.obs.SLOSpec(kind=kind, **kw)


def _latency(ns, reg, seconds, n=1, graph="g"):
    hist = reg.histogram(ns.slo.LATENCY_FAMILY, labels=("graph",))
    for _ in range(n):
        hist.labels(graph=graph).observe(seconds)


def _slo_flood(ns, mon, reg):
    mon.tick(0.0)
    _latency(ns, reg, 0.5, n=10)
    mon.tick(1.0)


def _slo_both_windows(ns, mon, reg):
    _slo_flood(ns, mon, reg)
    for t in range(2, 60):
        _latency(ns, reg, 0.0001, n=50)
        mon.tick(float(t))


def _slo_hysteresis(ns, mon, reg):
    mon.tick(0.0)
    _latency(ns, reg, 0.5, n=20)
    mon.tick(1.0)
    for t in range(2, 200):
        _latency(ns, reg, 0.5, n=1)
        _latency(ns, reg, 0.0001, n=3)
        mon.tick(float(t))
    for t in range(200, 360):
        _latency(ns, reg, 0.0001, n=3)
        mon.tick(float(t))


def _slo_min_events(ns, mon, reg):
    mon.tick(0.0)
    _latency(ns, reg, 0.5, n=4)
    mon.tick(1.0)
    _latency(ns, reg, 0.5, n=1)
    mon.tick(2.0)


def _slo_buckets(ns, mon, reg):
    mon.tick(0.0)
    _latency(ns, reg, 0.001, n=7)
    _latency(ns, reg, 0.002, n=3)
    mon.tick(1.0)


def _slo_shed(ns, mon, reg):
    served = reg.counter(ns.slo.SERVED_FAMILY, labels=("graph",))
    shed = reg.counter(ns.slo.SHED_FAMILY, labels=("graph",))
    late = reg.counter(ns.slo.DEADLINE_SHED_FAMILY, labels=("graph",))
    mon.tick(0.0)
    served.labels(graph="a").inc(6)
    shed.labels(graph="a").inc(3)
    late.labels(graph="a").inc(1)
    shed.labels(graph="b").inc(50)
    mon.tick(1.0)
    served.labels(graph="a").inc(100)
    mon.tick(40.0)


def _slo_quality(ns, mon, reg):
    hist = reg.histogram(ns.slo.QUALITY_FAMILY, bounds=ns.slo._UNIT_BUCKETS)
    mon.tick(0.0)
    for v in (0.95, 0.92, 0.97, 0.40, 0.70):
        hist.get().observe(v)
    mon.tick(1.0)


def _slo_ring(ns, mon, reg):
    for t in range(500):
        if t % 7 == 0:
            _latency(ns, reg, 0.5 if t % 3 else 0.0001, n=2)
        mon.tick(float(t))


SLO_SCENARIOS = {
    "flood-after-boot": ([("latency", {})], _slo_flood),
    "both-windows-of-a-pair": ([("latency", {})], _slo_both_windows),
    "hysteresis": ([("latency", {})], _slo_hysteresis),
    "min-events": ([("latency", {"min_events": 5})], _slo_min_events),
    "bucket-granularity": ([("latency", {})], _slo_buckets),
    "shed-kinds-and-graph-scope": ([("shed", {}), ("shed", {"name": "shed_a",
                                                             "graph": "a"}),
                                    ("shed", {"name": "shed_b", "graph": "b"})],
                                   _slo_shed),
    "quality": ([("quality", {"budget": 0.02})], _slo_quality),
    "ring-pruning": ([("latency", {})], _slo_ring),
    "default-specs": (None, _slo_ring),
}


@pytest.mark.parametrize("name", sorted(SLO_SCENARIOS))
def test_slo_monitor_states_and_burn_rates_equal_reference(name):
    specs_kw, drive = SLO_SCENARIOS[name]

    def run(ns):
        reg = ns.obs.MetricsRegistry()
        rec = ns.obs.FlightRecorder()
        specs = (ns.obs.default_slo_specs() if specs_kw is None else
                 [_spec(ns, kind, **kw) for kind, kw in specs_kw])
        mon = ns.obs.SLOMonitor(reg, specs, time_fn=FakeClock(),
                                recorder=rec, resolution_s=1.0)
        drive(ns, mon, reg)
        return {"status": mon.status(), "states": mon.states(),
                "burning": mon.burning(),
                "kinds": sorted(mon.burning_kinds()),
                "events": rec.events(), "text": ns.obs.format_slo(mon.status()),
                "prometheus": ns.obs.prometheus_text(reg),
                "ring": {k: len(st.samples) for k, st in mon._states.items()}}

    got = _both(run)
    assert got["status"]["specs"]


def test_slo_spec_validation_equal_reference():
    bad = [dict(name=""), dict(kind="throughput"), dict(budget=0.0),
           dict(budget=1.5), dict(kind="latency", objective=0.0),
           dict(kind="quality", objective=1.5), dict(fast_windows=(30.0, 5.0)),
           dict(slow_windows=(0.0, 120.0)), dict(fast_burn=2.0, slow_burn=6.0),
           dict(recover_burn=0.0), dict(min_events=0)]

    def run(ns):
        out = []
        for kw in bad:
            base = dict(name="s", kind="latency", objective=0.25)
            base.update(kw)
            try:
                ns.obs.SLOSpec(**base)
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        specs = ns.obs.default_slo_specs()
        return {"errors": out, "defaults": [dataclasses.asdict(s) for s in specs],
                "windows": [s.windows for s in specs]}

    got = _both(run)
    assert None not in got["errors"]


# ---------------------------------------------------------------------------
# OTLP: the committed golden fixture, and the exporter's other paths
# ---------------------------------------------------------------------------
def test_otlp_export_byte_equal_to_golden(monkeypatch):
    """``tests/test_otlp.py``'s golden scenario with the port's classes."""
    for name in ("OTLPExporter", "Tracer", "MetricsRegistry"):
        monkeypatch.setattr(test_otlp, name, getattr(tobs, name))
    got = test_otlp.build_golden()
    with open(test_otlp.GOLDEN, encoding="utf-8") as fh:
        want = fh.read()
    assert got == want
    assert tobs.OTLPExporter.__module__ == "repro_torch.obs.otlp"


def _otlp_paths(ns):
    """Delta pushes, retries, drops, batching, overflow and the mirrored
    counters, on a scripted clock and a failing-then-recovering transport."""
    clk = FakeClock()
    sent, attempts = [], [0]

    def transport(url, body):
        attempts[0] += 1
        if attempts[0] in (2, 3, 5, 6, 9):
            raise ConnectionError("collector unreachable")
        sent.append((url, json.loads(body.decode("utf-8"))))

    reg = ns.obs.MetricsRegistry()
    exp = ns.obs.OTLPExporter("http://collector:4318/", transport=transport,
                              time_fn=clk, sleep_fn=lambda s: None,
                              flush_interval_s=2.0, max_batch=3,
                              queue_capacity=7, max_retries=1, backoff_s=0.5,
                              registry=reg)
    tracer = ns.obs.Tracer(time_fn=clk, sink=exp.record_trace)
    c = reg.counter("hits_total", "Hits.", labels=("route",))
    h = reg.histogram("lat_seconds", "Latency.", bounds=(0.01, 0.1))
    out = []
    for step in range(8):
        for i in range(2 + 3 * (step % 3)):
            tr = tracer.start("query", "query", step=step, i=i)
            clk.t += 0.25
            tr.span("stage", clk(), ok=bool(i % 2)).end(clk() + 0.125)
            tracer.finish(tr)
        c.labels(route=("a", "b")[step % 2]).inc(step + 1)
        h.get().observe(0.005 * (step + 1))
        clk.t += 1.0
        out.append((exp.due(), exp.tick(reg), exp.stats()))
    out.append(exp.flush(reg))
    return {"steps": out, "sent": sent, "stats": exp.stats(),
            "mirror": ns.obs.prometheus_text(reg)}


def test_otlp_exporter_paths_equal_reference():
    got = _both(_otlp_paths)
    stats = got["stats"]
    assert stats["send_failures"] > 0 and stats["send_retries"] > 0
    assert stats["spans_dropped"] > 0 and stats["metric_pushes"] > 0


def _port_manifest() -> str:
    """``tests/test_metric_names.py::build_manifest`` (lines 21-40) over a
    fresh port stack: ``ServiceTelemetry``, the pump's counters, the SLO
    monitor's and the OTLP exporter's families."""
    registry = TTelemetry().registry
    registry.counter("ppr_pump_cycles_total", "Pump heartbeat cycles run.")
    registry.counter("ppr_pump_waves_launched_total",
                     "Waves launched from pump cycles (incl. the stop flush).")
    tobs.SLOMonitor(registry, tobs.default_slo_specs())
    tobs.OTLPExporter("http://localhost:4318", transport=lambda url, body: None,
                      registry=registry)
    lines = [
        "# Metric families of the PPR serving stack (generated — do not edit).",
        "# Regenerate after an intentional metric change:",
        "#   PYTHONPATH=src python tests/test_metric_names.py --write",
        "",
    ]
    for name, kind, _help, _series in registry.collect():
        fam = registry._families[name]
        label_part = (" {" + ",".join(fam.label_names) + "}"
                      if fam.label_names else "")
        lines.append(f"{name} {kind}{label_part}")
    return "\n".join(lines) + "\n"


def test_metric_families_equal_manifest():
    with open(test_metric_names.MANIFEST) as fh:
        want = fh.read()
    assert _port_manifest() == want == test_metric_names.build_manifest()


def test_pump_counters_declared_like_reference():
    """The pump's heartbeat families, which the manifest declares by hand,
    are the ones the port's ``WavePump`` registers."""
    from repro.ppr_serving.http import WavePump as RPump
    from repro_torch.ppr_serving.http import WavePump as TPump

    def families(svc_cls, pump_cls, **kw):
        svc = svc_cls(kappa=2, iterations=2, **kw)
        pump_cls(svc)
        return [(n, k) for n, k, _h, _s in svc.telemetry.registry.collect()]

    assert families(TService, TPump, device=CPU) == families(RService, RPump)


# ---------------------------------------------------------------------------
# the traced service
# ---------------------------------------------------------------------------
def _graph(v=V_PRIME, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    return COOGraph.from_edges(rng.integers(0, v - 40, e),
                               rng.integers(0, v, e), v)


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _norm(obj):
    """Trace dicts with the engine names mapped onto the port's."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(v) for v in obj)
    if isinstance(obj, str) and obj.startswith("pallas_"):
        return "fused_" + obj[len("pallas_"):]
    return obj


def _split_residuals(snap):
    """Pop every ``residual`` attribute out of the snapshot's traces, as
    ``(precision, residual)`` pairs in walk order."""
    out = []

    def walk(span, precision):
        attrs = span.get("attrs", {})
        if "residual" in attrs:
            out.append((precision, attrs.pop("residual")))
        for child in span.get("children", ()):
            walk(child, precision)

    for t in snap["traces"]:
        walk(t["root"], t["root"].get("attrs", {}).get("precision"))
    return out


def _residuals_close(got, want):
    """Fixed point: the states are bit-identical, so only the Σd² row's
    summation order differs: rtol 1e-5.  float32: near an ε exit the state
    change is a few hundred ulps of the state, and the two packages' states
    differ by float32 rounding (|δP| ≲ 1e-10 on the fixture's scores), so
    the residual also carries an absolute term of that rounding over
    sqrt(V) entries: rtol 1e-5 + atol 1e-9."""
    assert [(p, r is None) for p, r in got] == [(p, r is None) for p, r in want]
    for (prec, g), (_, w) in zip(got, want):
        if g is not None:
            atol = 1e-9 if prec == "f32" else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol)


POLICIES = {
    "no-exit": None,
    "exit": dict(epsilon=1e-6, min_iterations=2, check_every=1),
    "checks-before-min": dict(epsilon=1e-6, min_iterations=7, check_every=2),
    "min-past-budget": dict(epsilon=1e-6, min_iterations=40, check_every=3),
}


def _traced_traffic(side, g, family, tracing, policy, iterations):
    """One service through a scripted history: two full waves of mixed
    precision, cache hits, a deadline shed, a delta that invalidates a
    pending query and a re-registration that replaces one.  Returns the
    answers, the recorder snapshot and the traced-query vertex sets."""
    ref = side == "ref"
    Service, Query = (RService, RQuery) if ref else (TService, TQuery)
    Policy, EdgeDelta = (RPolicy, REdgeDelta) if ref else (TPolicy, TEdgeDelta)
    gg = g if ref else graph_from_arrays(g.x, g.y, g.val, g.dangling,
                                         g.num_vertices)
    kw = {} if ref else {"device": CPU}
    svc = Service(kappa=4, iterations=iterations, max_wait=100.0,
                  tracing=tracing, time_fn=TickingClock(),
                  early_exit=None if policy is None else Policy(**policy), **kw)
    svc.register_graph("g", gg, formats=[20], packet=64, engine=family)
    answers = []

    def run(queries):
        futs = [svc.submit(q) for q in queries]
        svc.flush()
        for f in futs:
            try:
                r = f.result()
            except Exception as e:            # QueryRejected
                answers.append(("rejected", getattr(e, "code", None)))
            else:
                answers.append((r.source, r.precision, r.vertices.tolist(),
                                np.asarray(r.scores, np.float64)))

    mixed = [Query("g", v, k=6, precision=p)
             for v, p in [(3, "Q1.19"), (17, None), (100, "Q1.19"),
                          (250, "Q1.19"), (3, None), (600, "Q1.19"),
                          (42, None), (77, None)]]
    run(mixed)
    run([Query("g", 3, k=6, precision="Q1.19"), Query("g", 42, k=6)])  # hits
    run([Query("g", 5, k=6, precision="Q1.19", deadline=0.0)])       # shed
    pending = [svc.submit(Query("g", v, k=4, precision="Q1.19"))
               for v in (11, 12)]
    svc.apply_delta("g", EdgeDelta(add_src=np.array([11]),
                                   add_dst=np.array([500])))
    pending.append(svc.submit(Query("g", 13, k=4)))
    svc.register_graph("g", gg, formats=[20], packet=64, engine=family)
    for f in pending:
        try:
            f.result()
            answers.append("resolved")
        except Exception as e:
            answers.append(("rejected", getattr(e, "code", None)))
    run([Query("g", v, k=5, precision="Q1.19") for v in (1, 2, 3, 4, 5)])
    snap = svc.recorder.snapshot()
    sampled = sorted(t["root"]["attrs"]["vertex"] for t in snap["traces"]
                     if t["kind"] == "query")
    return answers, snap, sampled


def _answers_equal(got, want, float_tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if not (isinstance(a, tuple) and len(a) == 4):
            assert a == b
            continue
        assert a[:3] == b[:3]
        if a[1] == "f32":
            np.testing.assert_allclose(a[3], b[3], rtol=0, atol=float_tol)
        else:
            assert np.array_equal(a[3], b[3])


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("tracing", [True, 0.5], ids=["traced", "sampled"])
@pytest.mark.parametrize("families", [("single", "single"), ("pallas", "fused")],
                         ids=["single", "fused"])
def test_traced_service_equal_reference(graph, families, tracing, policy):
    iterations = 30 if policy == "exit" else 10
    pol = POLICIES[policy]
    want_ans, want, want_sampled = _traced_traffic(
        "ref", graph, families[0], tracing, pol, iterations)
    got_ans, got, got_sampled = _traced_traffic(
        "port", graph, families[1], tracing, pol, iterations)
    _answers_equal(got_ans, want_ans, 1e-6)
    assert got_sampled == want_sampled
    want, got = _norm(want), _norm(got)
    want_res, got_res = _split_residuals(want), _split_residuals(got)
    assert got == want
    _residuals_close(got_res, want_res)
    # the history's outcomes: hits, the shed, the delta and the replacement
    outcomes = [a for a in got_ans if isinstance(a, tuple) and a[0] == "rejected"]
    assert ("rejected", "deadline-exceeded") in outcomes
    assert ("rejected", "delta-invalidated") in outcomes
    assert ("rejected", "graph-replaced") in outcomes
    assert sum(a[0] == "cache" for a in got_ans if isinstance(a, tuple)) == 2
    kinds = {t["kind"] for t in got["traces"]}
    assert kinds == {"query", "wave"}
    if tracing is True:
        assert len(got_sampled) == 19
        rejected = [t for t in got["traces"]
                    if t["root"]["attrs"].get("outcome") == "rejected"]
        assert sorted(t["root"]["attrs"]["code"] for t in rejected) == [
            "deadline-exceeded", "delta-invalidated", "graph-replaced",
            "graph-replaced"]
    else:
        assert 0 < len(got_sampled) < 19
    for t in got["traces"]:
        if t["kind"] == "wave":
            names = [c["name"] for c in t["root"]["children"]]
            assert names == ["plan", "warm_start", "iterate", "topk", "resolve"]
            it = t["root"]["children"][2]["attrs"]
            assert it["budget"] == iterations
            if pol is None:
                assert "residual" not in it
    if policy == "exit":
        assert any(t["root"]["children"][2]["attrs"]["early_exit"]
                   for t in got["traces"] if t["kind"] == "wave")


@pytest.mark.parametrize("family", ["single", "fused"])
@pytest.mark.parametrize("tracing", [True, 0.5], ids=["traced", "sampled"])
def test_traced_answers_equal_untraced(graph, family, tracing):
    """Tracing reads residuals; it must not change an answer or an
    iteration count."""
    pol = POLICIES["checks-before-min"]
    traced, snap, _ = _traced_traffic("port", graph, family, tracing, pol, 30)
    plain, plain_snap, _ = _traced_traffic("port", graph, family, False, pol, 30)
    _answers_equal(traced, plain, 0.0)
    assert snap["traces"] and not plain_snap["traces"]
    untimed = lambda evs: [{k: v for k, v in e.items() if k != "t_s"}
                           for e in evs]
    assert untimed(snap["events"]) == untimed(plain_snap["events"])


def test_tracing_rate_validation_and_off_state():
    g = graph_from_arrays(*(lambda c: (c.x, c.y, c.val, c.dangling,
                                       c.num_vertices))(_graph(v=60, e=200)))
    assert TService(device=CPU).tracer is None
    assert TService(device=CPU, tracing=0.0).tracer is None
    assert TService(device=CPU, tracing=0.5).tracer is not None
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError):
            TService(device=CPU, tracing=bad)
    svc = TService(kappa=2, device=CPU, slo=True)
    svc.register_graph("g", g)
    assert [s.kind for s in svc.slo.specs] == ["latency", "shed", "quality"]
    assert svc.export_telemetry() == 0
