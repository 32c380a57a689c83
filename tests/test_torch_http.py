"""Port parity, the HTTP serving tier: ``repro_torch.ppr_serving.http``
(schemas, admission, pump, client, server) against
``repro.ppr_serving.http``.

The tier is stdlib asyncio, copied from the reference, so each scripted
scenario runs through both packages and must give equal results: parsed
schemas and their error messages, the admission controller's transitions
and service calls over one queue-depth script (with and without a burning
SLO), the rejection-path status mapping (409/410/429/504, never 500), and
the response bodies of two real servers on 127.0.0.1 port 0 — the port's
over a CPU service — for the same request sequence, with the timing fields
masked.  The pump's offload runs the port's waves on its own worker thread
while the loop keeps answering.
"""
import asyncio
import dataclasses
import json
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.graph_updates import EdgeDelta as REdgeDelta  # noqa: E402
from repro.graphs import holme_kim_powerlaw  # noqa: E402
from repro import obs as robs  # noqa: E402
from repro.ppr_serving import PPRQuery as RQuery  # noqa: E402
from repro.ppr_serving import PPRService as RService  # noqa: E402
from repro.ppr_serving import ServiceTelemetry as RTelemetry  # noqa: E402
from repro.ppr_serving import http as rhttp  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.graph_updates import EdgeDelta as TEdgeDelta  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.ppr_serving import PPRQuery as TQuery  # noqa: E402
from repro_torch.ppr_serving import PPRService as TService  # noqa: E402
from repro_torch.ppr_serving import ServiceTelemetry as TTelemetry  # noqa: E402
from repro_torch.ppr_serving import http as thttp  # noqa: E402

CPU = "cpu"


def _side(ref):
    if ref:
        return SimpleNamespace(http=rhttp, obs=robs, Service=RService, Query=RQuery,
                               Telemetry=RTelemetry,
                               EdgeDelta=REdgeDelta, kw={}, graph=lambda g: g)
    return SimpleNamespace(
        http=thttp, obs=tobs, Service=TService, Query=TQuery, Telemetry=TTelemetry,
        EdgeDelta=TEdgeDelta, kw={"device": CPU},
        graph=lambda g: graph_from_arrays(g.x, g.y, g.val, g.dangling,
                                          g.num_vertices))


REF, PORT = _side(True), _side(False)


def _both(scenario):
    want, got = scenario(REF), scenario(PORT)
    assert got == want
    return got


@pytest.fixture(scope="module")
def graph():
    return holme_kim_powerlaw(400, m=4, seed=2)


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------
BODIES = [
    b'{"graph": "g", "vertex": 3}',
    b'{"graph": "g", "vertex": 3, "k": 7, "precision": "auto", '
    b'"quality_target": 0.93, "deadline_s": 0.05}',
    b'{"graph": "g", "vertex": 3, "precision": 20, "k": null}',
    b'{"graph": "g", "vertex": 3, "precision": "Q1.25", "deadline_s": 1}',
    b"",
    b"{",
    b"[1, 2]",
    b'{"vertex": 3}',
    b'{"graph": "g", "vertex": true}',
    b'{"graph": "g", "vertex": 3.5}',
    b'{"graph": 7, "vertex": 3}',
    b'{"graph": "g", "vertex": 3, "k": "ten"}',
    b'{"graph": "g", "vertex": 3, "precision": [26]}',
    b'{"graph": "g", "vertex": 3, "quality_target": "high"}',
    b'{"graph": "g", "vertex": 3, "colour": "red", "alpha": 0.9}',
]


@pytest.mark.parametrize("body", BODIES, ids=[f"body{i}" for i in range(len(BODIES))])
def test_schema_parse_equal_reference(body):
    def run(ns):
        try:
            return dataclasses.asdict(ns.http.PPRRequestSchema.parse(body))
        except ns.http.SchemaError as e:
            return ("SchemaError", str(e), isinstance(e, ValueError))

    _both(run)


def test_payload_helpers_equal_reference():
    def run(ns):
        q = ns.Query("g", 5, k=3, precision="Q1.19")
        rec = SimpleNamespace(query=q, precision="Q1.19", source="wave",
                              wave_id=np.int64(4), latency_s=np.float32(0.25),
                              vertices=np.array([9, 2, 7], np.int32),
                              scores=np.array([0.5, 0.25, 0.125]))
        return [ns.http.recommendation_payload(rec, degraded=True),
                ns.http.error_payload("nope", "shed", retry_after_s=0.1),
                ns.http.error_payload("gone", "graph-replaced"),
                ns.http.schemas.dumps({"a": [1, 2.5, "x"], "b": None})]

    _both(run)


# ---------------------------------------------------------------------------
# admission: one queue-depth script through both controllers
# ---------------------------------------------------------------------------
class StubSLO:
    def __init__(self, kinds_by_tick):
        self.kinds_by_tick, self.ticks = kinds_by_tick, 0

    def tick(self, now=None):
        self.ticks += 1

    def burning_kinds(self):
        return frozenset(self.kinds_by_tick.get(self.ticks, ()))

    def burning(self):
        return sorted(self.burning_kinds())


class StubService:
    """The controller's service contract with a dialable depth; every hook
    call is logged."""

    def __init__(self, ns, kappa=4):
        self.kappa = kappa
        self.telemetry = ns.Telemetry()
        self.recorder = ns.obs.FlightRecorder()
        self.depth = 0
        self.calls = []
        self.time_fn = lambda: 0.0

    def queue_depth(self):
        return self.depth

    def oldest_wait_s(self, now=None):
        return 0.0

    def set_kappa(self, kappa):
        self.calls.append(("set_kappa", kappa))
        self.telemetry.record_kappa_change(deepened=kappa > self.kappa)
        self.kappa = kappa

    def degrade_quality(self, target):
        self.calls.append(("degrade", target))

    def restore_quality(self):
        self.calls.append(("restore", None))


DEPTHS = [0, 3, 4, 7, 9, 12, 20, 33, 40, 8, 5, 7, 3, 2, 1, 0, 16, 70, 64, 65,
          2, 0, 0, 6, 1]
CONFIGS = {
    "small": dict(high_water=8, low_water=2, deepen_water=4, kappa_max=16,
                  degrade_water=6, degrade_low_water=2, degraded_target=0.9),
    "chip-burst": dict(high_water=48, low_water=4, deepen_water=4, kappa_max=64,
                       degrade_water=24, degrade_low_water=4),
    "defaults": {},
}
SLO_SCRIPTS = {
    "no-slo": None,
    "latency-burn": {t: ("latency",) for t in range(2, 9)},
    "quality-burn": {t: ("quality",) for t in range(3, 20)},
    "shed-then-quality": {**{t: ("shed",) for t in range(1, 6)},
                          **{t: ("quality", "shed") for t in range(6, 12)}},
}


@pytest.mark.parametrize("slo", sorted(SLO_SCRIPTS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_admission_transitions_equal_reference(config, slo):
    def run(ns):
        svc = StubService(ns, kappa=4)
        script = SLO_SCRIPTS[slo]
        ctl = ns.http.AdmissionController(
            svc, ns.http.AdmissionConfig(**CONFIGS[config]),
            slo=None if script is None else StubSLO(script))
        trail = []
        for i, depth in enumerate(DEPTHS):
            svc.depth = depth
            if i % 3:
                trail.append(("admit", ctl.admit(now=float(i), graph="g")))
            else:
                trail.append(("tick", ctl.tick(now=float(i))))
            trail.append((svc.kappa, ctl.shedding, ctl.degrading))
        return {"trail": trail, "calls": svc.calls, "stats": ctl.stats(),
                "targets": [ctl.target_kappa(d) for d in range(0, 130, 7)],
                "events": svc.recorder.events(),
                "summary": svc.telemetry.summary()}

    got = _both(run)
    assert any(c[0] == "set_kappa" for c in got["calls"])


def test_admission_config_validation_equal_reference():
    bad = [dict(low_water=0), dict(low_water=100), dict(degrade_low_water=40),
           dict(deepen_water=0), dict(kappa_max=0), dict(degraded_target=0.0),
           dict(degraded_target=1.5), dict(retry_after_s=0.0)]

    def run(ns):
        out = []
        for kw in bad:
            try:
                ns.http.AdmissionConfig(**kw)
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        try:
            ns.http.AdmissionController(StubService(ns, kappa=128),
                                        ns.http.AdmissionConfig())
        except ValueError as e:
            out.append(str(e))
        return out

    got = _both(run)
    assert None not in got and len(got) == len(bad) + 1


def test_set_kappa_equal_reference(graph):
    """The service hook the controller drives: telemetry, the recorder's
    κ events and the scheduler's depth."""
    def run(ns):
        svc = ns.Service(kappa=4, iterations=3, time_fn=lambda: 1.5, **ns.kw)
        svc.register_graph("g", ns.graph(graph))
        for k in (8, 8, 16, 4, 64):
            svc.set_kappa(k)
        try:
            svc.set_kappa(0)
        except ValueError as e:
            err = str(e)
        futs = [svc.submit(ns.Query("g", v, k=3)) for v in range(70)]
        waves = svc.flush()
        s = svc.telemetry_summary()
        return {"kappa": (svc.kappa, svc.scheduler.kappa), "err": err,
                "events": svc.recorder.events(), "waves": waves,
                "occ": [len(f.result().vertices) for f in futs][:3],
                "counts": (s["kappa_deepen_events"], s["kappa_relax_events"])}

    got = _both(run)
    assert got["kappa"] == (64, 64) and got["waves"] == 2


# ---------------------------------------------------------------------------
# real servers on 127.0.0.1:0, the same requests to both
# ---------------------------------------------------------------------------
_TIMING = re.compile(r"(latency|_s$|_seconds|_per_s|wait|cycles|ticks|"
                     r"duration|residual|burn_rate|bad_fraction)")


def _mask(obj, key=""):
    """Timing fields, heartbeat counts (and the residual, checked
    elsewhere) → a token."""
    if isinstance(obj, dict):
        return {k: _mask(v, k) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v, key) for v in obj]
    if (isinstance(obj, (int, float)) and not isinstance(obj, bool)
            and _TIMING.search(key)):
        return "<t>"
    return obj


def _served(ns, graph, requests):
    """The request sequence, one at a time, against a fresh server over a
    κ = 1 service (so every miss is its own full wave).  The latency SLO's
    objective (2^25 µs) sits far above any wave here, so that no burn —
    and no κ push — depends on the host's speed; each precision's first
    wave (the reference's compile) runs before the server starts."""
    specs = ns.obs.default_slo_specs(latency_objective_s=33.554432)
    svc = ns.Service(kappa=1, iterations=6, max_wait=100.0,
                     early_exit=True, tracing=True, slo=specs, **ns.kw)
    svc.register_graph("g", ns.graph(graph), formats=[20])
    svc.run_batch([ns.Query("g", 100 + i, k=3, precision=p)
                   for i, p in enumerate((None, 20, "Q1.25", "auto"))])
    server = ns.http.PPRHTTPServer(svc, pump_interval_s=0.002)

    async def scenario():
        await server.start()
        out = []
        client = ns.http.AsyncHTTPClient(server.host, server.port)
        try:
            for method, path, body in requests:
                status, headers, payload = await client.request(method, path, body)
                if isinstance(payload, str):          # Prometheus text
                    payload = sorted(line.split(" ")[0] for line in payload.splitlines()
                                     if line and not line.startswith("#"))
                out.append((status, headers.get("content-type"),
                            headers.get("retry-after"), payload))
        finally:
            await client.close()
            await server.stop()
        return out

    return asyncio.run(asyncio.wait_for(scenario(), 120)), svc


REQUESTS = [
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 5, "k": 4, "precision": 20}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 9, "k": 6}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 5, "k": 4, "precision": 20}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 17, "k": 3, "precision": "auto"}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 17, "k": 3, "precision": "Q1.25",
                         "deadline_s": 5.0}),
    ("POST", "/v1/ppr", {"graph": "nope", "vertex": 1}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 4000}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 1, "k": 0}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 1, "precision": "Q9.x"}),
    ("POST", "/v1/ppr", {"graph": "g", "vertex": 1, "bogus": 1}),
    ("GET", "/v1/ppr", None),
    ("GET", "/v1/nowhere", None),
    ("GET", "/v1/healthz", None),
    ("GET", "/v1/stats", None),
    ("GET", "/v1/metrics", None),
    ("GET", "/v1/metrics?format=json", None),
    ("GET", "/v1/slo?n=4", None),
    ("GET", "/v1/slo?n=x", None),
    ("GET", "/v1/debug/traces?n=5", None),
    ("GET", "/v1/debug/traces?n=oops", None),
]


def test_server_response_bodies_equal_reference(graph):
    want, _ = _served(REF, graph, REQUESTS)
    got, svc = _served(PORT, graph, REQUESTS)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    statuses = [r[0] for r in got]
    assert 500 not in statuses
    assert statuses[:5] == [200] * 5 and statuses[5:8] == [404, 400, 400]
    for (gs, _, _, gp), (ws, _, _, wp) in zip(got, want):
        if isinstance(gp, dict):
            assert _mask(gp).keys() == _mask(wp).keys()
    by_path = {}
    for (method, path, _), g, w in zip(REQUESTS, got, want):
        by_path.setdefault(path, []).append((g[3], w[3]))
    # answers: raw-equal (Q1.19 / Q1.25) or within 1e-6 (f32), latency masked
    for g, w in by_path["/v1/ppr"]:
        g, w = _mask(g), _mask(w)
        if "recommendations" in g and g["precision"] == "f32":
            gs = [r.pop("score") for r in g["recommendations"]]
            ws = [r.pop("score") for r in w["recommendations"]]
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        assert g == w
    for path in ("/v1/healthz", "/v1/slo?n=4", "/v1/slo?n=x",
                 "/v1/debug/traces?n=oops", "/v1/metrics", "/v1/ppr",
                 "/v1/nowhere"):
        for g, w in by_path[path]:
            assert _mask(g) == _mask(w)
    (g, w), = by_path["/v1/debug/traces?n=5"]
    assert g["tracing"] and len(g["traces"]) == len(w["traces"]) == 5
    assert _mask(g)["events"] == _mask(w)["events"]
    (g, w), = by_path["/v1/stats"]
    for key in ("queries_served", "waves", "cache_hits", "cache_misses",
                "admission_admitted", "admission_shed", "admission_kappa",
                "early_exit_waves", "queries_auto", "waves_fused"):
        assert g.get(key) == w.get(key), key
    (g, w), = by_path["/v1/metrics?format=json"]
    assert sorted(g) == sorted(w)
    assert svc.queue_depth() == 0


def test_status_mapping_never_500_equal_reference(graph):
    """429 under a tight admission config, 504 past a deadline, 409 on a
    delta-invalidated pending query and 410 on a replaced graph: the same
    statuses and bodies from both servers."""
    def run(ns):
        g = ns.graph(graph)
        svc = ns.Service(kappa=8, iterations=3, max_wait=100.0, **ns.kw)
        svc.register_graph("g", g)
        server = ns.http.PPRHTTPServer(svc, pump_interval_s=0.002,
                                       admission=ns.http.AdmissionConfig(
                                           high_water=2, low_water=1,
                                           deepen_water=100, kappa_max=8))

        async def pending(host, port, body):
            depth = svc.queue_depth()
            task = asyncio.create_task(ns.http.http_request(
                host, port, "POST", "/v1/ppr", body))
            # queued, or (a deadline of 0) already shed by the pump
            while svc.queue_depth() == depth and not task.done():
                await asyncio.sleep(0.002)
            return task

        async def scenario():
            await server.start()
            host, port = server.host, server.port
            out = []
            tasks = [await pending(host, port, {"graph": "g", "vertex": v, "k": 3})
                     for v in (3, 4, 5)]
            shed = [await ns.http.http_request(
                host, port, "POST", "/v1/ppr", {"graph": "g", "vertex": v})
                for v in (6, 7)]
            out += [(s, h.get("retry-after"), p) for s, h, p in shed]
            svc.register_graph("g", g)                     # → 410 x3
            out += [(s, None, p) for s, _, p in await asyncio.gather(*tasks)]
            task = await pending(host, port, {"graph": "g", "vertex": 11})
            svc.apply_delta("g", ns.EdgeDelta(add_src=np.array([11]),
                                              add_dst=np.array([20])))
            s, _, p = await task                           # → 409
            out.append((s, None, p))
            task = await pending(host, port, {"graph": "g", "vertex": 12,
                                              "deadline_s": 0.0})
            await asyncio.sleep(0.01)
            svc.flush()                                    # → 504
            s, _, p = await task
            out.append((s, None, re.sub(r"\d+\.\d+s", "<t>s", json.dumps(p))))
            out.append(svc.queue_depth())
            await server.stop()
            return out

        return asyncio.run(asyncio.wait_for(scenario(), 120))

    got = _both(run)
    assert [r[0] for r in got[:-1]] == [429, 429, 410, 410, 410, 409, 504]
    assert got[-1] == 0


# ---------------------------------------------------------------------------
# the pump's offload
# ---------------------------------------------------------------------------
def test_pump_offloads_waves_to_its_worker_thread(graph):
    """The port's waves run on the pump's single worker thread, and the loop
    answers ``/v1/healthz`` while one is parked there."""
    svc = TService(kappa=1, iterations=3, max_wait=100.0, device=CPU)
    svc.register_graph("g", PORT.graph(graph))
    started, release = threading.Event(), threading.Event()
    threads = []
    orig = svc._run_wave

    def stuck_wave(wave):
        threads.append(threading.current_thread().name)
        started.set()
        assert release.wait(30.0)
        return orig(wave)

    svc._run_wave = stuck_wave
    server = thttp.PPRHTTPServer(svc, pump_interval_s=0.002)

    async def scenario():
        await server.start()
        host, port = server.host, server.port
        post = asyncio.create_task(thttp.http_request(
            host, port, "POST", "/v1/ppr", {"graph": "g", "vertex": 7, "k": 4}))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10.0
        while not started.is_set():
            assert loop.time() < deadline, "wave never launched"
            await asyncio.sleep(0.002)
        status, _, health = await thttp.http_request(host, port, "GET", "/v1/healthz")
        assert status == 200 and not post.done()
        release.set()
        status, _, payload = await post
        await server.stop()
        return status, payload

    status, payload = asyncio.run(scenario())
    assert status == 200 and len(payload["recommendations"]) == 4
    assert threads and all(t.startswith("ppr-wave") for t in threads)
    assert threading.current_thread().name not in threads
    assert server.pump._executor is None


def test_pump_offload_false_runs_in_loop_and_stop_flushes(graph):
    svc = TService(kappa=4, iterations=3, max_wait=100.0, device=CPU)
    svc.register_graph("g", PORT.graph(graph))
    pump = thttp.WavePump(svc, interval_s=0.001, offload=False)

    async def scenario():
        pump.start()
        assert pump._executor is None
        futs = [svc.submit(TQuery("g", v, k=4)) for v in (1, 2)]  # partial wave
        await asyncio.sleep(0.01)
        assert not any(f.done() for f in futs)
        await pump.stop()                       # the stop flush serves them
        return [f.result() for f in futs]

    recs = asyncio.run(scenario())
    assert [r.source for r in recs] == ["wave", "wave"]
    assert pump.waves_launched == 1 and pump.cycles > 0
    with pytest.raises(ValueError):
        thttp.WavePump(svc, interval_s=0.0)


def test_failing_wave_ends_the_pump_like_the_reference(graph):
    """A wave that raises (a kernel that fails to build or launch) ends the
    pump task with its exception in both packages, and ``stop()`` raises
    it: the failure is loud, never a silent fallback.  The wave's futures
    stay pending, so an HTTP client waiting on one gets no answer (the
    reference's contract, kept)."""
    def run(ns):
        svc = ns.Service(kappa=1, iterations=3, max_wait=100.0, **ns.kw)
        svc.register_graph("g", ns.graph(graph))

        def failing_wave(wave):
            raise RuntimeError("fused_ppr_launch failed")

        svc._run_wave = failing_wave
        pump = ns.http.WavePump(svc, interval_s=0.002)

        async def scenario():
            pump.start()
            fut = svc.submit(ns.Query("g", 7, k=3))
            task = pump._task
            await asyncio.wait_for(asyncio.wait([task]), 10.0)
            try:
                await pump.stop()
                raised = None
            except RuntimeError as e:
                raised = str(e)
            if pump._executor is not None:
                pump._executor.shutdown(wait=True)
            return (task.done(), type(task.exception()).__name__, fut.done(), raised)

        return asyncio.run(scenario())

    got = _both(run)
    assert got == (True, "RuntimeError", False, "fused_ppr_launch failed")
