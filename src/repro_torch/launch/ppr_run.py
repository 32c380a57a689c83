"""End-to-end Personalized PageRank driver — the paper's own workload.

Counterpart of ``repro.launch.ppr_run``.

    PYTHONPATH=src python -m repro_torch.launch.ppr_run --graph pl_1e5 --scale 0.02 \
        --bits 26 --requests 100 --kappa 8
    PYTHONPATH=src python -m repro_torch.launch.ppr_run --device cpu   # plain versions

Reproduces the paper's §5.1 protocol: compute PPR for N random personalization
vertices in κ-sized batches, at a chosen fixed-point bit-width, and score the
rankings against the float64 CPU oracle at convergence (§5.3 metrics).

``--serve`` routes the same workload through ``PPRService`` (κ-batched waves,
top-K, telemetry) instead of the raw ``batched_ppr`` loop; ``--replay-deltas N``
serves a Zipf-ish query mix on a live service and replays N edge-delta rounds
against it (scoped invalidation, warm start, prefetch re-warming).

Everything runs on ``--device`` (``cuda`` unless the caller asks for the CPU;
asking for ``cuda`` on a host without a GPU raises).  Not ported yet, each
raising ``NotImplementedError`` that names its slice before any graph is
built: ``--http`` (the HTTP slice), ``--shards N>1`` (the multi-GPU slice),
and ``--trace``, ``--dump-traces``, ``--trace-sample``, ``--slo`` and
``--otlp-endpoint`` (the observability slice).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.ppr_serving.slices import HTTP_SLICE, MESH_SLICE, OBS_SLICE, not_ported


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
                         f"(N>1 comes with {MESH_SLICE})")
    ap.add_argument("--topk", type=int, default=10,
                    help="with --serve: recommendations per query")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help=f"serve the graph over HTTP on PORT (comes with {HTTP_SLICE})")
    ap.add_argument("--replay-deltas", type=int, default=0, metavar="N",
                    help="dynamic-updates mode: serve a Zipf-ish query mix, "
                         "then replay N random edge-delta rounds against the "
                         "live service (scoped invalidation + warm-start), "
                         "re-serving the same traffic after each")
    ap.add_argument("--delta-edges", type=int, default=64,
                    help="with --replay-deltas: edge insertions per round "
                         "(half as many removals ride along)")
    ap.add_argument("--trace", action="store_true",
                    help=f"arm per-query span tracing (comes with {OBS_SLICE})")
    ap.add_argument("--dump-traces", type=int, default=0, metavar="N",
                    help=f"print the flight recorder's last N traces (comes with "
                         f"{OBS_SLICE})")
    ap.add_argument("--trace-sample", type=float, default=None, metavar="RATE",
                    help=f"head-sample tracing at RATE (comes with {OBS_SLICE})")
    ap.add_argument("--slo", action="store_true",
                    help=f"with --http: arm the SLO burn-rate monitor (comes with "
                         f"{OBS_SLICE})")
    ap.add_argument("--otlp-endpoint", default=None, metavar="URL",
                    help=f"with --http: export to an OTLP/HTTP collector (comes "
                         f"with {OBS_SLICE})")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu for the plain "
                         "PyTorch versions)")
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    """Raise for a flag whose slice is not ported yet, naming the slice."""
    unported = [("--http", args.http is not None, HTTP_SLICE),
                ("--shards N>1", args.shards > 1, MESH_SLICE),
                ("--trace", args.trace, OBS_SLICE),
                ("--dump-traces", bool(args.dump_traces), OBS_SLICE),
                ("--trace-sample", args.trace_sample is not None, OBS_SLICE),
                ("--slo", args.slo, OBS_SLICE),
                ("--otlp-endpoint", args.otlp_endpoint is not None, OBS_SLICE)]
    for flag, given, slice_name in unported:
        if given:
            raise not_ported(f"ppr_run {flag}", slice_name)


def main(argv=None):
    args = _parse_args(argv)
    _refuse_unported(args)

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

    if args.replay_deltas:
        _replay_deltas(args, g, fmt, label, dev)
        return
    if args.serve:
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
    """PPRService path: waves + top-K + telemetry on one device.

    Returns None (skipping the dense-score oracle comparison): the service
    returns ranked top-K results, not dense score matrices.  This driver
    reports serving throughput and wave telemetry."""
    from repro_torch.ppr_serving import PPRQuery, PPRService

    svc = PPRService(kappa=args.kappa, iterations=args.iterations,
                     alpha=args.alpha, cache_capacity=0,      # measure compute
                     device=dev)
    svc.register_graph(args.graph, g, formats=[] if fmt is None else [fmt])
    precision = None if fmt is None else fmt.name
    queries = [PPRQuery(args.graph, int(v), k=args.topk, precision=precision)
               for v in vertices]

    svc.run_batch(queries[: min(args.kappa, len(queries))])   # warm up
    svc.telemetry.reset()              # report only the timed traffic
    t0 = time.time()
    recs = svc.run_batch(queries)
    dt = time.time() - t0
    print(f"{label} via PPRService on single-device: {len(recs)} queries in {dt:.3f}s "
          f"({len(recs)/dt:.1f} req/s, κ={args.kappa}, top-{args.topk})")
    t = svc.telemetry_summary()
    for k in sorted(t):
        if k.startswith(("waves", "queries_", "wave_latency", "mean_occ",
                         "engine_")):
            v = t[k]
            print(f"  {k:28s} {v:.5f}" if isinstance(v, float) else
                  f"  {k:28s} {v}")
    return None


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
                     prefetch=True, device=dev)
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


if __name__ == "__main__":
    main()
