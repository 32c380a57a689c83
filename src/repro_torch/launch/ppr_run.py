"""End-to-end Personalized PageRank driver — the paper's own workload.

Counterpart of ``repro.launch.ppr_run``.

    PYTHONPATH=src python -m repro_torch.launch.ppr_run --graph pl_1e5 --scale 0.02 \
        --bits 26 --requests 100 --kappa 8
    PYTHONPATH=src python -m repro_torch.launch.ppr_run --device cpu   # plain versions

Reproduces the paper's §5.1 protocol: compute PPR for N random personalization
vertices in κ-sized batches, at a chosen fixed-point bit-width, and score the
rankings against the float64 CPU oracle at convergence (§5.3 metrics).

``--serve`` routes the same workload through ``PPRService`` (κ-batched waves,
top-K, telemetry) instead of the raw ``batched_ppr`` loop; ``--shards N``
additionally registers the graph on an N-way mesh (``launch.mesh.make_mesh``
on ``--device``: shard i on ``cuda:{i % cards}``), so waves run the sharded
engines with each shard's SpMV through the streaming SpMV kernel;
``--replay-deltas N``
serves a Zipf-ish query mix on a live service and replays N edge-delta rounds
against it (scoped invalidation, warm start, prefetch re-warming);
``--http PORT`` serves the graph behind the asyncio HTTP tier until
interrupted.  ``--trace``/``--trace-sample``/``--dump-traces`` arm span
tracing and print the flight recorder; ``--slo`` and ``--otlp-endpoint``
arm the SLO monitor and the OTLP exporter of the HTTP mode.

Everything runs on ``--device`` (``cuda`` unless the caller asks for the CPU;
asking for ``cuda`` on a host without a GPU raises).

    PYTHONPATH=src python -m repro_torch.launch.ppr_run --serve --shards 4
"""
from __future__ import annotations

import argparse
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="pl_1e5")
    ap.add_argument("--scale", type=float, default=0.02,
                    help="graph-size scale (1.0 = paper size |V|=1e5/2e5)")
    ap.add_argument("--bits", type=int, default=26)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--kappa", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=0.85)
    ap.add_argument("--float", dest="use_float", action="store_true",
                    help="run the F32 reference architecture instead")
    ap.add_argument("--serve", action="store_true",
                    help="route through PPRService (waves, top-K, telemetry)")
    ap.add_argument("--shards", type=int, default=1,
                    help="with --serve: register the graph on an N-way mesh "
                         "(shard i on cuda:{i %% cards}; every shard on the "
                         "CPU with --device cpu)")
    ap.add_argument("--topk", type=int, default=10,
                    help="with --serve: recommendations per query")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the graph over HTTP on PORT (0 = ephemeral): "
                         "asyncio tier with admission control, load shedding "
                         "and SLO-aware quality degradation; runs until "
                         "interrupted (POST /v1/ppr, GET /v1/healthz, "
                         "GET /v1/stats)")
    ap.add_argument("--replay-deltas", type=int, default=0, metavar="N",
                    help="dynamic-updates mode: serve a Zipf-ish query mix, "
                         "then replay N random edge-delta rounds against the "
                         "live service (scoped invalidation + warm-start), "
                         "re-serving the same traffic after each")
    ap.add_argument("--delta-edges", type=int, default=64,
                    help="with --replay-deltas: edge insertions per round "
                         "(half as many removals ride along)")
    ap.add_argument("--trace", action="store_true",
                    help="with --serve/--http/--replay-deltas: arm per-query "
                         "span tracing (every query records its admission "
                         "wait, cache probe, wave execution and convergence "
                         "into the flight recorder)")
    ap.add_argument("--dump-traces", type=int, default=0, metavar="N",
                    help="after the run, print the flight recorder's last N "
                         "traces as span trees plus control-plane events "
                         "(implies --trace)")
    ap.add_argument("--trace-sample", type=float, default=None, metavar="RATE",
                    help="head-sample tracing at RATE in (0, 1] instead of "
                         "tracing everything (implies --trace; seeded, so a "
                         "replayed run samples the same queries)")
    ap.add_argument("--slo", action="store_true",
                    help="with --http: arm the SLO burn-rate monitor "
                         "(default latency/shed/quality specs, GET /v1/slo, "
                         "burn-driven admission advisories)")
    ap.add_argument("--otlp-endpoint", default=None, metavar="URL",
                    help="with --http: export spans + delta metrics to an "
                         "OTLP/HTTP collector at URL (POSTs to URL/v1/traces "
                         "and URL/v1/metrics); the flight recorder still "
                         "records everything locally")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu for the plain "
                         "PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)

    import numpy as np

    from repro_torch.core import PPRConfig, batched_ppr, format_for_bits
    from repro_torch.core.metrics import aggregate_reports, full_report
    from repro_torch.device import resolve_device
    from repro_torch.graphs import paper_graph_suite, ppr_reference

    dev = resolve_device(args.device)
    suite = paper_graph_suite(scale=args.scale)
    g = suite[args.graph]
    print(f"graph {args.graph}: |V|={g.num_vertices:,} |E|={g.num_edges:,} "
          f"sparsity={g.sparsity:.2e}")
    rng = np.random.default_rng(0)
    vertices = rng.integers(0, g.num_vertices, args.requests)
    cfg = PPRConfig(alpha=args.alpha, iterations=args.iterations, kappa=args.kappa)
    fmt = None if args.use_float else format_for_bits(args.bits)
    label = "float32" if fmt is None else fmt.name

    if args.http is not None:
        _serve_http(args, g, fmt, label, dev)
        return
    if args.replay_deltas:
        _replay_deltas(args, g, fmt, label, dev)
        return
    if args.serve or args.shards > 1:
        scores = _serve(args, g, vertices, fmt, label, dev)
    else:
        t0 = time.time()
        scores = batched_ppr(g, vertices, cfg, fmt=fmt, device=dev)
        dt = time.time() - t0
        print(f"{label}: {args.requests} requests in {dt:.3f}s "
              f"({args.requests/dt:.1f} req/s, κ={args.kappa})")

    if scores is None:
        return
    # accuracy vs converged CPU oracle (paper §5.3: ≥100 iterations)
    n_acc = min(8, args.requests)
    ref = ppr_reference(g, vertices[:n_acc], alpha=args.alpha, iterations=100)
    reports = [full_report(scores[:, i], ref[:, i]) for i in range(n_acc)]
    agg = aggregate_reports(reports)
    print(f"accuracy vs CPU oracle (first {n_acc} requests):")
    for k in ["ndcg", "edit@10", "edit@20", "errors@10", "precision@50", "kendall@50", "mae"]:
        print(f"  {k:14s} {agg[k]:.5f}")


def _serve(args, g, vertices, fmt, label, dev):
    """PPRService path: waves + top-K + telemetry, optionally mesh-sharded.

    Returns None (skipping the dense-score oracle comparison): the service
    returns ranked top-K results, not dense score matrices.  This driver
    reports serving throughput and per-mesh wave telemetry."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import PPRQuery, PPRService

    mesh = None
    if args.shards > 1:
        mesh = make_mesh((args.shards,), ("shard",), device=dev)
        print(f"mesh: {args.shards} shards on {mesh.placement}")
    svc = PPRService(kappa=args.kappa, iterations=args.iterations,
                     alpha=args.alpha, cache_capacity=0,      # measure compute
                     tracing=_tracing(args), device=dev)
    svc.register_graph(args.graph, g, formats=[] if fmt is None else [fmt],
                       mesh=mesh)
    precision = None if fmt is None else fmt.name
    queries = [PPRQuery(args.graph, int(v), k=args.topk, precision=precision)
               for v in vertices]

    svc.run_batch(queries[: min(args.kappa, len(queries))])   # warm up
    svc.telemetry.reset()              # report only the timed traffic
    t0 = time.time()
    recs = svc.run_batch(queries)
    dt = time.time() - t0
    where = "single-device" if mesh is None else f"{args.shards}-shard mesh"
    print(f"{label} via PPRService on {where}: {len(recs)} queries in {dt:.3f}s "
          f"({len(recs)/dt:.1f} req/s, κ={args.kappa}, top-{args.topk})")
    t = svc.telemetry_summary()
    for k in sorted(t):
        if k.startswith(("waves", "queries_", "wave_latency", "mean_occ",
                         "engine_")):
            v = t[k]
            print(f"  {k:28s} {v:.5f}" if isinstance(v, float) else
                  f"  {k:28s} {v}")
    if args.dump_traces:
        _dump_recorder(svc, args.dump_traces)
    return None


def _serve_http(args, g, fmt, label, dev):
    """HTTP serving mode: the registered graph behind the asyncio tier.

    Auto-precision is always armed (the SLO degradation path needs the
    controller); an explicit --bits additionally pre-quantizes that format so
    explicit-precision requests skip the first-touch quantization upload."""
    import asyncio

    from repro_torch.ppr_serving import PPRHTTPServer, PPRService

    otlp = None
    if args.otlp_endpoint:
        from repro_torch.obs import OTLPExporter
        otlp = OTLPExporter(args.otlp_endpoint)
    svc = PPRService(kappa=args.kappa, iterations=args.iterations,
                     alpha=args.alpha, max_wait=0.005, early_exit=True,
                     tracing=_tracing(args), slo=args.slo or None, otlp=otlp,
                     device=dev)
    svc.register_graph(args.graph, g, formats=[] if fmt is None else [fmt])
    server = PPRHTTPServer(svc, port=args.http)

    async def _run():
        await server.start()
        print(f"{label}: serving graph {args.graph!r} "
              f"(|V|={g.num_vertices:,}) on http://{server.host}:{server.port}")
        print(f"  POST /v1/ppr      "
              f'{{"graph": "{args.graph}", "vertex": 0, "k": {args.topk}, '
              f'"precision": "auto"}}')
        print("  GET  /v1/healthz  liveness + queue depth")
        print("  GET  /v1/stats    telemetry + admission counters")
        print("  GET  /v1/metrics  Prometheus text exposition (?format=json)")
        if svc.slo is not None:
            print("  GET  /v1/slo      SLO states + burn rates (?n=K events)")
        print("  GET  /v1/debug/traces  flight recorder (?n=K)")
        if otlp is not None:
            print(f"  exporting OTLP to {otlp.endpoint} "
                  f"(/v1/traces, /v1/metrics)")
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        print("\nshutting down")
    if otlp is not None:
        s = otlp.stats()
        print(f"otlp: {s['spans_exported']} spans in "
              f"{s['span_batches_sent']} batches, "
              f"{s['metric_pushes']} metric pushes, "
              f"{s['spans_dropped']} dropped, "
              f"{s['send_failures']} failed sends")
    if args.dump_traces:
        _dump_recorder(svc, args.dump_traces)


def _replay_deltas(args, g, fmt, label, dev):
    """Dynamic-updates showcase: one live service absorbing delta rounds.

    Traffic is Zipf-ish (a small hot set queried every round) so the three
    update-time mechanisms are all visible: scoped invalidation keeps
    off-frontier cache entries serving, warm-start re-converges invalidated
    hot vertices in fewer iterations, and the prefetcher re-warms what the
    delta dropped during the idle poll between rounds."""
    import numpy as np

    from repro_torch.graph_updates import localized_delta, random_delta
    from repro_torch.ppr_serving import PPRQuery, PPRService

    rng = np.random.default_rng(0)
    hot = rng.integers(0, g.num_vertices, max(4, args.kappa))
    cold_pool = rng.integers(0, g.num_vertices, 4 * len(hot))

    svc = PPRService(kappa=args.kappa, iterations=args.iterations,
                     alpha=args.alpha, early_exit=True, warm_start=True,
                     prefetch=True, tracing=_tracing(args), device=dev)
    svc.register_graph(args.graph, g,
                       formats=[] if fmt is None else [fmt])
    precision = None if fmt is None else fmt.name

    def traffic(round_i):
        verts = list(hot) + list(rng.choice(cold_pool, len(hot)))
        return [PPRQuery(args.graph, int(v), k=args.topk, precision=precision)
                for v in verts]

    svc.run_batch(traffic(0))                   # warm up builds + caches
    print(f"{label}: replaying {args.replay_deltas} delta rounds of "
          f"~{args.delta_edges + args.delta_edges // 2} edges on "
          f"{args.graph} (|V|={g.num_vertices:,})")
    for i in range(args.replay_deltas):
        rg = svc.registered_graph(args.graph)
        grow = args.delta_edges // 16 if i % 2 else 0
        # alternate global churn with localized low-connectivity bursts —
        # the localized rounds are where scoped invalidation retains entries
        if i % 2 == 0:
            d = localized_delta(rg.source, rng, n_add=args.delta_edges,
                                n_remove=args.delta_edges // 2)
        else:
            d = random_delta(rg.source, rng, n_add=args.delta_edges,
                             n_remove=args.delta_edges // 2, grow=grow)
        rep = svc.apply_delta(args.graph, d)
        svc.poll()                              # idle poll → prefetch re-warm
        t0 = time.time()
        recs = svc.run_batch(traffic(i + 1))
        dt = time.time() - t0
        cached = sum(r.source == "cache" for r in recs)
        print(f"  round {i + 1}: epoch={rep['epoch']} "
              f"+{rep['edges_added']}/-{rep['edges_removed']} edges "
              f"(apply {rep['apply_s'] * 1e3:.1f} ms, "
              f"frontier {rep['frontier_size']}), "
              f"cache dropped {rep['cache_dropped']} / kept {rep['cache_retained']}, "
              f"re-serve {len(recs)} q in {dt:.3f}s ({cached} cached)")
    t = svc.telemetry_summary()
    print("telemetry:")
    for k in ("deltas_applied", "edges_added", "edges_removed",
              "scoped_invalidations", "scoped_cache_retained",
              "warm_start_waves", "warm_start_iterations_saved",
              "prefetch_issued", "cache_hit_rate", "early_exit_waves",
              "iterations_saved"):
        v = t[k]
        print(f"  {k:28s} {v:.4f}" if isinstance(v, float) else
              f"  {k:28s} {v}")
    if args.dump_traces:
        _dump_recorder(svc, args.dump_traces)


def _tracing(args):
    """The service's ``tracing`` argument: a sample rate when requested,
    else the plain on/off bool."""
    if args.trace_sample is not None:
        return args.trace_sample
    return bool(args.trace or args.dump_traces)


def _dump_recorder(svc, n):
    """Print the flight recorder's tail: control-plane events (the incident
    timeline), then the last ``n`` completed traces as span trees."""
    from repro_torch.obs import format_event, format_trace

    snap = svc.recorder.snapshot(n_traces=n, n_events=n)
    print(f"flight recorder: {snap['traces_recorded']} traces / "
          f"{snap['events_recorded']} events recorded "
          f"(rings {snap['trace_capacity']}/{snap['event_capacity']})")
    for ev in snap["events"]:
        print("  " + format_event(ev))
    for tr in snap["traces"]:
        for line in format_trace(tr).splitlines():
            print("  " + line)


if __name__ == "__main__":
    main()
