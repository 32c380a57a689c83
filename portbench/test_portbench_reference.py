"""The plain reference: against a scalar loop, against its own tie rule,
and against the port on the CPU at a tiny graph, across one delta."""
import numpy as np
import pytest
import torch

from portbench import arrivals, graphgen, reference as ref, verdict

ALPHA, ITERS = 0.85, 10


def scalar_fixed(src, dst, nv, pers, f, iters, alpha):
    """eq. (1) in Q1.f with Python integers, one vertex and edge at a time."""
    scale, mask, top = 1 << f, (1 << 32) - 1, (1 << (1 + f)) - 1
    outdeg = [0] * nv
    for s in src:
        outdeg[s] += 1
    val = [min(int(np.floor(float(np.float32(1.0 / outdeg[s])) * scale)), top)
           for s in src]
    a, oma, aov = int(alpha * scale), int((1.0 - alpha) * scale), int(alpha / nv * scale)
    p = [scale if i == pers else 0 for i in range(nv)]
    for _ in range(iters):
        xp = [0] * nv
        for e in range(len(src)):
            xp[dst[e]] = (xp[dst[e]] + ((val[e] * p[src[e]]) >> f & mask)) & mask
        dm = sum(p[i] for i in range(nv) if outdeg[i] == 0) & mask
        restart = [((oma * (scale if i == pers else 0)) >> f) & mask for i in range(nv)]
        p = [min(min(((a * xp[i]) >> f & mask) + ((aov * dm) >> f & mask), top)
                 + restart[i], top) for i in range(nv)]
    return p


def test_fixed_reference_equals_a_scalar_loop():
    rng = np.random.default_rng(5)
    nv = 40
    src = rng.integers(0, nv - 4, 150)       # the last four vertices dangle
    dst = rng.integers(0, nv, 150)
    g = ref.RefGraph(src, dst, nv)
    P = ref.ppr_fixed(g, np.array([3, 17]), 1, 25, ALPHA, ITERS)
    for col, v in enumerate([3, 17]):
        assert P[:, col].tolist() == scalar_fixed(src.tolist(), dst.tolist(), nv, v,
                                                  25, ITERS, ALPHA)


def test_fixed_topk_breaks_ties_by_lower_vertex_and_leaves_out_self():
    P = torch.tensor([[5, 1], [7, 9], [5, 9], [7, 2], [0, 9]], dtype=torch.int64)
    ids, raw = ref.topk_fixed(P, np.array([1, 4]), 3)
    assert ids.tolist() == [[3, 0, 2], [1, 2, 3]]
    assert raw.tolist() == [[7, 5, 5], [9, 9, 2]]


def test_float_reference_sums_to_one_without_dangling_mass_loss():
    src, dst = graphgen.erdos_renyi(500, 3000, arrivals.rng_for(2, "graph"))
    g = ref.RefGraph(src, dst, 500)
    P = ref.ppr_float(g, np.array([1, 2, 3]), ALPHA, 60)
    np.testing.assert_allclose(P.sum(0).numpy(), 1.0, atol=1e-9)


@pytest.mark.parametrize("precision,check", [(26, "q25_exact"), ("f32", "f32_float")])
@pytest.mark.parametrize("gen", ["erdos_renyi", "holme_kim_powerlaw"])
def test_port_on_the_cpu_agrees_with_the_reference_across_a_delta(precision, check, gen):
    from repro_torch.core.coo import COOGraph
    from repro_torch.graph_updates import EdgeDelta
    from repro_torch.ppr_serving import PPRQuery, PPRService

    spec = {"generator": gen, "num_vertices": 2000, "num_edges": 20000, "m": 8,
            "p_triad": 0.1}
    nv = 2000
    src, dst = graphgen.make_graph(spec, arrivals.rng_for(4, "graph"))
    (d,) = graphgen.delta_batch(src, nv, 1, 40, 20, arrivals.rng_for(4, "deltas"))
    svc = PPRService(kappa=16, iterations=ITERS, alpha=ALPHA, cache_capacity=0,
                     device="cpu")
    svc.register_graph("g", COOGraph.from_edges(src, dst, nv), formats=[26],
                       engine="fused")
    verts = arrivals.rng_for(4, "queries").integers(0, nv, 40)
    rows = []
    for version in (0, 1):
        if version:
            svc.apply_delta("g", EdgeDelta(add_src=d["add_src"], add_dst=d["add_dst"],
                                           remove_src=src[d["remove"]],
                                           remove_dst=dst[d["remove"]]))
        for r in svc.run_batch([PPRQuery("g", int(v), k=10, precision=precision)
                                for v in verts]):
            rows.append((r.query.vertex, version, r.vertices, r.scores))
    keep = np.ones(src.size, bool)
    keep[d["remove"]] = False
    graphs = [(src, dst, nv), (np.concatenate([src[keep], d["add_src"]]),
                               np.concatenate([dst[keep], d["add_dst"]]), nv)]
    answers = {"vertex": np.array([r[0] for r in rows]),
               "version": np.array([r[1] for r in rows]),
               "ids": np.stack([r[2] for r in rows]).astype(np.int64),
               "scores": np.stack([r[3] for r in rows])}
    spec_check = verdict.load_limits(check)
    numbers = verdict.judge(verdict_spec(check), lambda j: graphs[j], answers, "cpu",
                            alpha=ALPHA, iterations=ITERS)
    assert numbers.pop("checked") == 80
    assert all(numbers[m] <= spec_check[m] for m in spec_check), numbers


def verdict_spec(name):
    import json

    return json.loads((verdict.CHECKS / f"{name}.json").read_text())


@pytest.mark.parametrize("check", ["q25_exact", "f32_float"])
def test_short_repeated_or_self_including_lists_fail_the_check(check):
    src, dst = graphgen.erdos_renyi(300, 3000, arrivals.rng_for(1, "graph"))
    g = ref.RefGraph(src, dst, 300)
    pers = np.array([5, 6, 7, 8])
    ids, raw = ref.topk_fixed(ref.ppr_fixed(g, pers, 1, 25, ALPHA, ITERS), pers, 10)
    scores = raw / 2.0**25
    ids[1, 8:], scores[1, 8:] = -1, np.nan        # a short list
    ids[2, 1] = ids[2, 0]                         # a repeated vertex
    ids[3, 0] = 8                                 # the query's own vertex
    answers = {"vertex": pers, "version": np.zeros(4, np.int32),
               "ids": ids.astype(np.int64), "scores": scores}
    numbers = verdict.judge(verdict_spec(check), lambda j: (src, dst, 300), answers,
                            "cpu", alpha=ALPHA, iterations=ITERS)
    assert numbers["bad_lists"] == 3
