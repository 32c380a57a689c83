"""Quickstart: serve reduced-precision PPR recommendations through the
futures API and absorb live graph updates — the paper's architecture operated
as the recommender service it was built for, on the PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py                # on the GPU
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu   # plain PyTorch

register → submit (PPRFuture per query) → flush (κ-batched waves, bit-exact
Q1.25 fixed point, top-K) → apply_delta (epoch-versioned edge ingestion,
scoped invalidation, warm-start re-convergence) → submit again.  Counterpart
of ``examples/quickstart.py``; it prints the same lines.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.graph_updates import EdgeDelta
from repro_torch.graphs import holme_kim_powerlaw
from repro_torch.ppr_serving import PPRQuery, PPRService


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a social-network-like graph (Holme–Kim powerlaw, paper Table 1)
    g = holme_kim_powerlaw(2000, m=6, seed=0)
    print(f"graph: |V|={g.num_vertices:,} |E|={g.num_edges:,} sparsity={g.sparsity:.1e}")

    # 2. a serving instance: κ-batched waves, early-exit at the fixed-point
    #    absorbing state (paper Fig. 7), warm-start seeds across graph updates.
    #    register_graph picks the "single" engine family (plain PyTorch float +
    #    bit-exact fixed backends); engine="fused" runs the fused-iteration
    #    CUDA kernel, and mesh= the "sharded" family.
    svc = PPRService(kappa=4, iterations=40, early_exit=True, warm_start=True,
                     device=dev)
    svc.register_graph("social", g, formats=[26])       # pre-quantize Q1.25

    # 3. submit returns a PPRFuture per query; flush() launches the pending
    #    waves and resolves every future (a future's own .result() also drives)
    users = [17, 42, 1337, 1999]
    futures = [svc.submit(PPRQuery("social", u, k=5, precision=26)) for u in users]
    svc.flush()
    for fut in futures:
        rec = fut.result()
        print(f"user {rec.query.vertex:5d}: top-5 recs {rec.vertices.tolist()} "
              f"({rec.precision}, {rec.source})")

    # 4. a follower burst arrives: one new user joins (vertex growth) and
    #    follows two existing users, one of whom follows back — absorbed in
    #    place, no re-registration: only cache entries near the change are
    #    invalidated
    delta = EdgeDelta(add_src=[2000, 2000, 17], add_dst=[17, 42, 2000],
                      new_num_vertices=2001)
    report = svc.apply_delta("social", delta)
    print(f"delta applied in {report['apply_s']*1e3:.1f} ms: epoch {report['epoch']}, "
          f"|V| -> {report['num_vertices']}, cache dropped {report['cache_dropped']} "
          f"/ retained {report['cache_retained']} (frontier {report['frontier_size']})")

    # 5. serve the updated graph — invalidated users recompute (warm-started
    #    from their pre-delta converged state, so the wave early-exits sooner),
    #    untouched users resolve from cache before submit even returns, and the
    #    new user is immediately servable; done-callbacks fire on resolution
    futures = [svc.submit(PPRQuery("social", u, k=5, precision=26)) for u in users]
    futures[0].add_done_callback(
        lambda f: print(f"(callback) user {f.query.vertex} resolved "
                        f"from {f.result().source}"))
    svc.flush()
    for fut in futures:
        rec = fut.result()
        print(f"user {rec.query.vertex:5d}: top-5 recs {rec.vertices.tolist()} "
              f"({rec.precision}, {rec.source})")
    newbie = svc.submit(PPRQuery("social", 2000, k=5, precision=26)).result()
    print(f"user  2000: top-5 recs {newbie.vertices.tolist()} "
          f"({newbie.precision}, {newbie.source})")

    t = svc.telemetry_summary()
    print(f"telemetry: {t['waves']:.0f} waves "
          f"({t.get('engine_fixed_waves', 0):.0f} on the fixed engine), "
          f"early-exit saved {t['iterations_saved']:.0f} iterations, "
          f"warm-start saved {t['warm_start_iterations_saved']:.0f} more on "
          f"{t['warm_start_columns']:.0f} re-converged columns")


if __name__ == "__main__":
    main()
