"""Serving PPR over HTTP: the futures API behind the asyncio tier, on the
PyTorch port.

    PYTHONPATH=src python examples_torch/http_serving.py                # on the GPU
    PYTHONPATH=src python examples_torch/http_serving.py --device cpu   # plain PyTorch

Starts a `PPRHTTPServer` in-process (ephemeral port), fires a handful of
requests with the bundled asyncio client — explicit precision, auto
precision, a cache hit, a validation error — then pushes a burst past the
admission high-water mark to show load shedding (429 + Retry-After) and
SLO-aware quality degradation kicking in, and prints the /v1/stats audit
trail of every decision plus the flight recorder's reconstruction of the
incident (the shed/degrade/recover timeline and one query's span tree).
Counterpart of ``examples/http_serving.py``; it prints the same lines.
"""
import argparse
import asyncio

from repro_torch.device import resolve_device
from repro_torch.graphs import holme_kim_powerlaw
from repro_torch.obs import format_event, format_trace
from repro_torch.ppr_serving import AdmissionConfig, PPRHTTPServer, PPRService
from repro_torch.ppr_serving.http import AsyncHTTPClient, http_request


async def main(device):
    # 1. a graph behind a serving instance; tight water marks so the demo
    #    overloads on a laptop (production values scale with κ)
    g = holme_kim_powerlaw(1500, m=4, seed=0)
    svc = PPRService(kappa=4, iterations=10, max_wait=0.002, tracing=True,
                     device=device)
    svc.register_graph("social", g, formats=[26])
    server = PPRHTTPServer(svc, admission=AdmissionConfig(
        high_water=10, low_water=2, deepen_water=4, kappa_max=16,
        degrade_water=6, degrade_low_water=2, degraded_target=0.93))
    await server.start()
    host, port = server.host, server.port
    print(f"serving on http://{host}:{port}")

    # 2. ordinary traffic: explicit Q1.25, then auto precision
    for body in ({"graph": "social", "vertex": 17, "k": 5, "precision": 26},
                 {"graph": "social", "vertex": 42, "k": 5,
                  "precision": "auto", "quality_target": 0.95}):
        status, _, rec = await http_request(host, port, "POST", "/v1/ppr", body)
        print(f"vertex {body['vertex']}: HTTP {status} served at "
              f"{rec['precision']} from {rec['source']}, "
              f"top-5 {[r['vertex'] for r in rec['recommendations']]}")

    # 3. the same query again — resolved from the LRU before a wave forms
    status, _, rec = await http_request(
        host, port, "POST", "/v1/ppr",
        {"graph": "social", "vertex": 17, "k": 5, "precision": 26})
    print(f"repeat vertex 17: HTTP {status} from {rec['source']}")

    # 4. a bad request is a clean 400, not a poisoned wave
    status, _, err = await http_request(
        host, port, "POST", "/v1/ppr",
        {"graph": "social", "vertex": 17, "k": 0})
    print(f"k=0: HTTP {status} ({err['error']})")

    # 5. overload: a concurrent burst far past the high-water mark — the
    #    tail sheds with Retry-After, deep-queue auto traffic degrades to
    #    the 0.93 target, and both recover once the queue drains
    clients = [AsyncHTTPClient(host, port) for _ in range(32)]
    results = await asyncio.gather(*[
        c.request("POST", "/v1/ppr",
                  {"graph": "social", "vertex": 100 + i, "k": 5,
                   "precision": "auto", "quality_target": 0.95})
        for i, c in enumerate(clients)])
    for c in clients:
        await c.close()
    statuses = [r[0] for r in results]
    shed = [r for r in results if r[0] == 429]
    degraded = sum(r[2].get("degraded", False) for r in results if r[0] == 200)
    print(f"burst of {len(results)}: {statuses.count(200)} served "
          f"({degraded} at the degraded target), {len(shed)} shed"
          + (f" (Retry-After {shed[0][1]['retry-after']}s)" if shed else ""))

    # 6. the audit trail: every admission decision is telemetry
    status, _, stats = await http_request(host, port, "GET", "/v1/stats")
    print("stats:")
    for key in ("queries_served", "queries_shed", "queue_depth_peak",
                "shed_engaged_events", "shed_recovered_events",
                "slo_degrade_events", "slo_degraded_queries",
                "slo_recover_events", "kappa_deepen_events",
                "kappa_relax_events", "cache_hit_rate"):
        print(f"  {key:24s} {stats[key]}")

    # 7. the flight recorder replays the incident itself: the control-plane
    #    timeline (κ deepened → quality degraded → shedding engaged → queue
    #    drained → recovered) and, for any one query, the spans of what it
    #    waited on and where its wave spent the time
    print("flight recorder — incident timeline:")
    for ev in svc.recorder.events():
        print("  " + format_event(ev))
    burst_query = next(t for t in reversed(svc.recorder.traces())
                       if t["kind"] == "query"
                       and t["root"]["attrs"].get("source") == "wave")
    print("flight recorder — one burst query's span tree:")
    for line in format_trace(burst_query).splitlines():
        print("  " + line)

    await server.stop()
    print("server stopped")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch versions)")
    asyncio.run(main(resolve_device(ap.parse_args().device)))
