"""Port parity, serving: top-K, convergence, the engines and ``PPRService``
against the JAX reference (its "pallas" engine family runs its kernel in
interpret mode on the CPU; the port's "fused" family runs the kernel's plain
version on CPU tensors).

Re-runs of ``tests/test_pallas_engine.py``'s parity tests (lines 51, 64, 76
and 145) with the port on one side and the reference on the other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")

import jax.numpy as jnp  # noqa: E402

from repro.autotune import convergence as rconv  # noqa: E402
from repro.core.coo import COOGraph  # noqa: E402
from repro.core.fixed_point import format_for_bits  # noqa: E402
from repro.ppr_serving import PPRQuery as RQuery  # noqa: E402
from repro.ppr_serving import PPRService as RService  # noqa: E402
from repro.ppr_serving import get_engine as rget  # noqa: E402
from repro.ppr_serving import topk as rtopk  # noqa: E402
from repro_torch.autotune import convergence as tconv  # noqa: E402
from repro_torch.convert import graph_from_arrays, raw_to_numpy, raw_to_torch  # noqa: E402
from repro_torch.core.fixed_point import format_for_bits as tformat_for_bits  # noqa: E402
from repro_torch.ppr_serving import FusedRegisteredGraph  # noqa: E402
from repro_torch.ppr_serving import PPRQuery as TQuery  # noqa: E402
from repro_torch.ppr_serving import PPRService as TService  # noqa: E402
from repro_torch.ppr_serving import get_engine as tget  # noqa: E402
from repro_torch.ppr_serving import topk as ttopk  # noqa: E402
from repro_torch.ppr_serving.graphs import RegisteredGraph  # noqa: E402

ALPHA = 0.85
FMT = format_for_bits(20)
TFMT = tformat_for_bits(20)
V_PRIME = 641
CPU = "cpu"


def _graph(v=V_PRIME, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    # sources capped below v-40 ⇒ the tail vertices are dangling
    return COOGraph.from_edges(rng.integers(0, v - 40, e),
                               rng.integers(0, v, e), v)


def _port(g):
    return graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices)


def _fused_rg(g, **kw):
    kw.setdefault("packet", 64)
    kw.setdefault("v_tile", 128)     # multi-block on the prime-V test graphs
    return FusedRegisteredGraph("g", _port(g), device=CPU, **kw)


def _drive_ref(plan, pers):
    Vmat = plan.initial(jnp.asarray(pers, jnp.int32))
    return plan.iterate(lambda P_: plan.step(Vmat, P_), Vmat)


def _drive_port(plan, pers):
    Vmat = plan.initial(torch.as_tensor(pers, dtype=torch.int32))
    return plan.iterate(lambda P_: plan.step(Vmat, P_), Vmat)


# ---------------------------------------------------------------------------
# top-K
# ---------------------------------------------------------------------------
def _topk_columns(raw: bool):
    """[V, κ] columns with ties, many zeros, and excluded vertices both in
    and out of the top-k."""
    rng = np.random.default_rng(3)
    v, kappa = 97, 6
    P = np.zeros((v, kappa), np.float64)
    P[:, 0] = rng.integers(0, 4, v)                  # heavy ties
    P[:5, 1] = [9, 7, 7, 5, 5]                       # fewer nonzeros than k
    P[:, 2] = rng.random(v)
    P[:, 3] = 0                                      # an all-zero column
    P[::7, 4] = 3                                    # ties at the top
    P[:, 5] = rng.integers(0, 2, v)
    if raw:                                          # includes values ≥ 2^31
        return (P * 2**30).astype(np.uint64).astype(np.uint32) + np.uint32(2**31) * (P > 2)
    return P.astype(np.float32)


@pytest.mark.parametrize("raw", [False, True], ids=["float", "raw"])
@pytest.mark.parametrize("streaming", [False, True], ids=["dense", "streaming"])
def test_topk_ties_zeros_and_exclusion_match_reference(raw, streaming):
    P = _topk_columns(raw)
    exclude = np.array([0, 1, 50, 3, 7, 96], np.int32)   # inside and outside top-k
    k = 8
    if streaming:
        r = rtopk.topk_streaming(jnp.asarray(P), k, v_tile=16, exclude=jnp.asarray(exclude))
        t = ttopk.topk_streaming(raw_to_torch(P) if raw else torch.from_numpy(P), k,
                                 v_tile=16, exclude=torch.from_numpy(exclude))
    else:
        r = rtopk.topk_dense(jnp.asarray(P), k, exclude=jnp.asarray(exclude))
        t = ttopk.topk_dense(raw_to_torch(P) if raw else torch.from_numpy(P), k,
                             exclude=torch.from_numpy(exclude))
    assert np.array_equal(t[0].numpy(), np.asarray(r[0]))
    vals = raw_to_numpy(t[1]) if raw else t[1].numpy()
    assert np.array_equal(vals, np.asarray(r[1]))
    assert not np.any(t[0].numpy() == exclude[:, None])
    # without exclusion: ties still rank by ascending vertex id
    r = rtopk.topk_dense(jnp.asarray(P), k)
    t = ttopk.topk_dense(raw_to_torch(P) if raw else torch.from_numpy(P), k)
    assert np.array_equal(t[0].numpy(), np.asarray(r[0]))


def test_topk_rejects_k_above_vertices():
    P = torch.zeros((5, 2))
    with pytest.raises(ValueError):
        ttopk.topk_dense(P, 5, exclude=torch.tensor([0, 1]))
    with pytest.raises(ValueError):
        ttopk.topk_streaming(P, 3, v_tile=2)


# ---------------------------------------------------------------------------
# convergence + engines (tests/test_pallas_engine.py:51, 64, 76)
# ---------------------------------------------------------------------------
def test_wave_delta_and_states_equal_match_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (50, 3), dtype=np.uint64).astype(np.uint32)
    b = a.copy()
    b[3, 1] ^= 1
    assert tconv.wave_delta(raw_to_torch(b), raw_to_torch(a), 2**19) == pytest.approx(
        rconv.wave_delta(jnp.asarray(b), jnp.asarray(a), 2**19), rel=1e-6)
    assert tconv.states_equal(raw_to_torch(a), raw_to_torch(a.copy()))
    assert not tconv.states_equal(raw_to_torch(a), raw_to_torch(b))


def test_fused_fixed_raw_parity_with_fixed_engines():
    g = _graph()
    pers = [5, 123, 640, 7]
    ref = rget("fixed").plan(rget("float").make_graph("g", g), FMT, alpha=ALPHA,
                             iterations=8)
    fused = tget("fused_fixed").plan(_fused_rg(g), TFMT, alpha=ALPHA, iterations=8)
    single = tget("fixed").plan(RegisteredGraph("g", _port(g), device=CPU), TFMT,
                                alpha=ALPHA, iterations=8)
    P_ref, _ = _drive_ref(ref, pers)
    P_fused, _ = _drive_port(fused, pers)
    P_single, _ = _drive_port(single, pers)
    assert P_fused.dtype == torch.int32
    assert np.array_equal(raw_to_numpy(P_fused), np.asarray(P_ref))   # raw bits
    assert torch.equal(P_fused, P_single)


def test_fused_float_parity_within_1e6():
    g = _graph(seed=3)
    pers = [1, 2, 3, 600]
    ref = rget("float").plan(rget("float").make_graph("g", g), alpha=ALPHA,
                             iterations=8)
    fused = tget("fused_float").plan(_fused_rg(g), alpha=ALPHA, iterations=8)
    P_ref, _ = _drive_ref(ref, pers)
    P_fused, _ = _drive_port(fused, pers)
    assert float(np.abs(P_fused.numpy() - np.asarray(P_ref)).max()) < 1e-6


@pytest.mark.parametrize("check_every", [1, 3])
def test_early_exit_parity_with_run_until_converged(check_every):
    # tiny absorbing graph: the fixed path hits a strict fixed point or a
    # period-2 cycle inside the budget; the port's fused driver must return
    # the reference's state bit-for-bit AND its iteration count
    g = _graph(v=97, e=300, seed=5)
    pers = [0, 9, 96]
    pol_r = rconv.ConvergencePolicy(min_iterations=2, check_every=check_every)
    pol_t = tconv.ConvergencePolicy(min_iterations=2, check_every=check_every)
    budget = 80
    ref = rget("fixed").plan(rget("float").make_graph("g", g), FMT, alpha=ALPHA,
                             iterations=budget)
    Vref = ref.initial(jnp.asarray(pers, jnp.int32))
    P_ref, iters_ref, _ = rconv.run_until_converged(
        lambda P_: ref.step(Vref, P_), Vref, budget, pol_r,
        fixed=True, scale=FMT.scale, track_deltas=False)
    fused = tget("fused_fixed").plan(_fused_rg(g, v_tile=64), TFMT, alpha=ALPHA,
                                     iterations=budget, convergence=pol_t)
    P_fused, iters_fused = _drive_port(fused, pers)
    single = tget("fixed").plan(RegisteredGraph("g", _port(g), device=CPU), TFMT,
                                alpha=ALPHA, iterations=budget, convergence=pol_t)
    P_single, iters_single = _drive_port(single, pers)
    assert iters_fused < budget                       # actually exited early
    assert iters_fused == iters_single == iters_ref
    assert np.array_equal(raw_to_numpy(P_fused), np.asarray(P_ref))
    assert torch.equal(P_fused, P_single)


def test_fused_layout_covers_every_edge_once():
    rg = _fused_rg(_graph(seed=9))
    lay = rg.fused_layout()
    real = sum(int((r != 0).sum()) for r in lay.row_val)
    assert real == rg.source.num_edges
    assert int(lay.step_first.sum()) == lay.n_blk
    assert int(lay.step_last.sum()) == lay.n_blk
    # the device holds the pad-free stream only: one slot a real edge
    topo = rg.fused_topology()
    assert topo.col.dtype == torch.int32 and topo.num_rows == rg.num_vertices
    assert topo.num_edges == rg.fused_values(TFMT).shape[0] == real


# ---------------------------------------------------------------------------
# PPRService end to end (tests/test_pallas_engine.py:145)
# ---------------------------------------------------------------------------
def _serve(svc, graph, engine, precision, verts=(1, 7, 123, 640), query=None):
    svc.register_graph("g", graph, formats=[20], engine=engine)
    futs = [svc.submit(query("g", v, k=5, precision=precision)) for v in verts]
    svc.flush()
    return [f.result() for f in futs]


def test_service_fused_bit_identical_to_reference_pallas():
    g = _graph(seed=1)
    ref = _serve(RService(kappa=4, iterations=6, cache_capacity=0), g, "pallas", 20,
                 query=RQuery)
    for engine in ("fused", "single"):
        port = _serve(TService(kappa=4, iterations=6, cache_capacity=0, device=CPU),
                      _port(g), engine, 20, query=TQuery)
        for ra, rb in zip(ref, port):
            assert np.array_equal(ra.vertices, rb.vertices)
            assert np.array_equal(ra.scores, rb.scores)
            assert ra.precision == rb.precision == "Q1.19"


def test_service_float_and_early_exit_match_reference():
    g = _graph(seed=4)
    ref = _serve(RService(kappa=4, iterations=6, cache_capacity=0), g, "pallas", None,
                 query=RQuery)
    port = _serve(TService(kappa=4, iterations=6, cache_capacity=0, device=CPU),
                  _port(g), "fused", None, query=TQuery)
    for ra, rb in zip(ref, port):
        assert np.abs(ra.scores - rb.scores).max() < 1e-6
        assert np.all(np.isfinite(rb.scores)) and rb.vertices.shape == (5,)
    ref = _serve(RService(kappa=4, iterations=30, early_exit=True, cache_capacity=0),
                 g, "pallas", 20, query=RQuery)
    svc = TService(kappa=4, iterations=30, early_exit=True, cache_capacity=0, device=CPU)
    port = _serve(svc, _port(g), "fused", 20, query=TQuery)
    for ra, rb in zip(ref, port):
        assert np.array_equal(ra.vertices, rb.vertices)
        assert np.array_equal(ra.scores, rb.scores)
    summ = svc.telemetry_summary()
    assert summ["waves"] == 1 and summ["queries_served"] == 4


def test_service_cache_and_futures_paths():
    g = _port(_graph(seed=6))
    svc = TService(kappa=2, iterations=4, device=CPU)
    svc.register_graph("g", g, formats=[22], engine="fused")
    f1 = svc.submit(TQuery("g", 10, k=3, precision=22))
    assert svc.queue_depth() == 1
    rec = f1.result()                                 # drives its own wave
    assert rec.source == "wave" and 10 not in rec.vertices.tolist()
    again = svc.submit(TQuery("g", 10, k=3, precision=22)).result()
    assert again.source == "cache" and np.array_equal(again.vertices, rec.vertices)
    recs = svc.run_batch([TQuery("g", v, k=3, precision=None) for v in (1, 2, 3)])
    assert [r.query.vertex for r in recs] == [1, 2, 3]
    with pytest.raises(ValueError):
        svc.submit(TQuery("g", g.num_vertices, k=3))
    with pytest.raises(ValueError):
        svc.register_graph("h", g, engine="nope")


def test_service_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for hosts without one")
    with pytest.raises(RuntimeError, match="cuda"):
        TService(kappa=4)                            # default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        FusedRegisteredGraph("g", _port(_graph(v=50, e=100)))


@pytest.mark.parametrize("kwargs", [
    dict(tracing=True), dict(warm_start=True), dict(prefetch=True),
    dict(slo=True), dict(otlp=object()), dict(autotune=object()),
], ids=lambda kw: next(iter(kw)))
def test_later_slice_options_raise_not_implemented(kwargs):
    with pytest.raises(NotImplementedError, match="slice"):
        TService(device=CPU, **kwargs)


def test_later_slice_calls_raise_not_implemented():
    g = _port(_graph(v=60, e=200))
    svc = TService(device=CPU)
    svc.register_graph("g", g)
    for call in (lambda: svc.submit(TQuery("g", 1, precision="auto")),
                 lambda: svc.register_graph("m", g, mesh=object()),
                 lambda: svc.apply_delta("g", None),
                 lambda: svc.serve([]), lambda: svc.pump(), lambda: svc.drain()):
        with pytest.raises(NotImplementedError):
            call()
