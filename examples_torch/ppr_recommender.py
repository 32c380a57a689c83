"""E-commerce co-purchasing recommendations served through `PPRService`'s
futures API: κ-batched admission waves, per-query bit-width, streaming top-K,
and an LRU result cache — the paper's architecture (reduced-precision
streaming SpMV for PPR) operated as the recommender service it was built for,
on the PyTorch port.

    PYTHONPATH=src python examples_torch/ppr_recommender.py                # on the GPU
    PYTHONPATH=src python examples_torch/ppr_recommender.py --device cpu   # plain PyTorch

Counterpart of ``examples/ppr_recommender.py``; it prints the same lines.
"""
import argparse

import numpy as np

from repro_torch.autotune import AutotuneConfig, ShadowConfig
from repro_torch.core.metrics import topk_indices
from repro_torch.device import resolve_device
from repro_torch.graphs import holme_kim_powerlaw, ppr_reference
from repro_torch.ppr_serving import PPRQuery, PPRService


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    # Amazon-co-purchasing-like graph (paper Table 1: |V|=128k scaled down)
    g = holme_kim_powerlaw(12800, m=3, seed=1)
    print(f"catalog graph: |V|={g.num_vertices:,} products, |E|={g.num_edges:,} co-purchases")

    service = PPRService(kappa=8, iterations=10, cache_capacity=1024, device=dev)
    service.register_graph("amazon", g, formats=[20, 26])  # pre-quantize at registration

    # 100 user queries (paper §5.1 protocol), served per bit-width
    rng = np.random.default_rng(0)
    users = rng.integers(0, g.num_vertices, 100)

    for bits in (20, 26):
        # warm up on one wave (the device's caches, cuBLAS handles and the
        # allocator's pool), then measure a fresh service pass (those are
        # process-global, so only the stats start cold)
        service.run_batch([PPRQuery("amazon", int(v), k=10, precision=bits)
                           for v in users[:8]])
        svc = PPRService(kappa=8, iterations=10, cache_capacity=1024, device=dev)
        svc.register_graph("amazon", g, formats=[bits])
        recs = svc.run_batch([PPRQuery("amazon", int(v), k=10, precision=bits)
                              for v in users])
        s = svc.telemetry_summary()
        print(f"\nQ1.{bits-1}: {s['queries_served']:.0f} queries in "
              f"{sum(svc.telemetry.wave_latencies_s)*1000:.0f} ms "
              f"({s['queries_per_s']:.0f} queries/s, "
              f"{s['waves']:.0f} waves on the {s.get('engine_fixed_waves', 0):.0f}-wave "
              f"fixed engine, occupancy {s['mean_occupancy']:.2f}, "
              f"wave p95 {s['wave_latency_p95_s']*1000:.0f} ms)")

        # quality check on 3 queries vs converged oracle (self excluded, like
        # the service)
        ref = ppr_reference(g, users[:3], iterations=100)
        for i in range(3):
            s_ref = ref[:, i].copy()
            s_ref[users[i]] = -np.inf
            top_true = topk_indices(s_ref, 10)
            top_fast = recs[i].vertices
            overlap = len(set(top_fast.tolist()) & set(top_true.tolist()))
            print(f"  user {users[i]:6d}: top-10 overlap with oracle {overlap}/10 "
                  f"top-3 recs {top_fast[:3].tolist()}")

    # repeat traffic: the LRU cache short-circuits the whole iteration
    # pipeline — a repeat submit returns an already-resolved future (no wave,
    # no flush)
    repeat = [PPRQuery("amazon", int(v), k=10, precision=26) for v in users[:20]]
    service.run_batch(repeat)
    again = [service.submit(q) for q in repeat]
    assert all(f.done() for f in again)            # resolved before flush
    s = service.telemetry_summary()
    print(f"\nrepeat traffic: {sum(f.result().source == 'cache' for f in again)}/20 "
          f"served from cache (service hit rate {s['cache_hit_rate']:.2f})")

    # adaptive precision: ask for a quality target instead of a bit-width —
    # the autotune subsystem picks the cheapest Q format whose shadow-sampled
    # NDCG meets it, and early-exits waves at the fixed-point absorbing state
    auto_svc = PPRService(kappa=8, iterations=100, early_exit=True,
                          autotune=AutotuneConfig(
                              shadow=ShadowConfig(sample_fraction=0.5, seed=0)),
                          device=dev)
    auto_svc.register_graph("amazon", g)
    auto_recs = auto_svc.run_batch(
        [PPRQuery("amazon", int(v), k=10, precision="auto", quality_target=0.95)
         for v in users[:32]])
    s = auto_svc.telemetry_summary()
    served = {r.precision for r in auto_recs}
    print(f"\nauto precision (NDCG target 0.95): served at {sorted(served)}, "
          f"shadow NDCG {s['shadow_quality_mean']:.4f} over "
          f"{s['shadow_evaluations']:.0f} samples, early exit saved "
          f"{s['iterations_saved']:.0f} iterations across {s['waves']:.0f} waves")


if __name__ == "__main__":
    main()
