"""The CUDA kernels on the card against their plain PyTorch versions.

Every test takes the ``cuda`` fixture, which skips on a host without a CUDA
card: the hand-written kernels run only there.  This file imports no JAX (the
card's machine has none), so on a GPU host it runs as

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import coo as tcoo  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402
from repro_torch.core.coo import COOGraph  # noqa: E402
from repro_torch.graph_updates import EdgeDelta, random_delta  # noqa: E402
from repro_torch.graphs import erdos_renyi  # noqa: E402
from repro_torch.core.quantization import quantize_weights  # noqa: E402
from repro_torch.kernels import fused_ppr as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import topk_select as tsel  # noqa: E402
from repro_torch.kernels.coo_spmv import coo_spmv_kernel, coo_spmv_plain  # noqa: E402
from repro_torch.kernels.dst_stream import build_dst_stream  # noqa: E402
from repro_torch.kernels.fixed_matmul import (  # noqa: E402
    K_STEP,
    cta_slots,
    plan_splits,
    quantized_matmul_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_gqa,
    flash_attention_gqa_plain,
)
from repro_torch.ppr_serving import FusedRegisteredGraph, get_engine  # noqa: E402
from repro_torch.ppr_serving.topk import topk_dense  # noqa: E402
from repro_torch.ppr_serving.engine import fused as efused  # noqa: E402
from test_torch_topk_select import rank_columns  # noqa: E402

ALPHA = 0.85
V_PRIME = 641


@pytest.fixture
def cuda():
    """The CUDA device, or a skip on hosts without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _prime_graph(v=V_PRIME, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    # sources capped below v-40 ⇒ the tail vertices are dangling
    return COOGraph.from_edges(rng.integers(0, v - 40, e), rng.integers(0, v, e), v)


@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
def test_cuda_coo_spmv_matches_plain(cuda, fmt):
    g = erdos_renyi(3000, 30000, seed=2)
    b = tcoo.BlockedCOO.build(g, v_tile=512, packet=256)
    rng = np.random.default_rng(0)
    p = rng.random((b.n_src * 512, 16)).astype(np.float32) / 3000
    p = torch.from_numpy(p) if fmt is None else fmt.from_float(torch.from_numpy(p))
    out_k = tops.coo_spmv(b, p.to(cuda), fmt=fmt).cpu()
    out_p = tops.coo_spmv(b, p, fmt=fmt)
    if fmt is None:
        torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-8)
    else:
        assert torch.equal(out_k, out_p)


def _fused_operands(g, fmt, k, slice_edges=None, v_tile=128, packet=64, seed=1,
                    p_scale=None, vm_stride=7):
    """CPU operands of one fused iteration over ``g``'s dst stream: (topology,
    values, dangling list, V̄, P) and the keywords.  P is U(0, 1)·``p_scale``,
    by default 2/V: a PPR-scale state whose columns sum to about 1, as the
    served states do."""
    v = g.num_vertices
    st = build_dst_stream(tfused.build_fused_layout(g, v_tile, packet),
                          slice_edges=slice_edges)
    dang_idx = torch.from_numpy(np.nonzero(g.dangling)[0].astype(np.int32))
    rng = np.random.default_rng(seed)
    scale = 2 / v if p_scale is None else p_scale
    p = torch.from_numpy((rng.random((v, k)) * scale).astype(np.float32))
    vm = torch.zeros((v, k))
    vm[torch.arange(k) * vm_stride % v, torch.arange(k)] = 1.0
    if fmt is not None:
        p, vm = fmt.from_float(p), fmt.from_float(vm)
    args = (st.topology("cpu"), st.values("cpu", fmt), dang_idx, vm, p)
    return args, dict(alpha=ALPHA, fmt=fmt)


def _check_fused(P_k, res_k, P_p, res_p, fixed):
    if fixed:
        assert torch.equal(P_k.cpu(), P_p)
        assert torch.equal(res_k[1].cpu(), res_p[1])
    else:
        torch.testing.assert_close(P_k.cpu(), P_p, rtol=1e-5, atol=1e-9)
        assert float((P_k.cpu() - P_p).abs().max()) <= 1e-6
    torch.testing.assert_close(res_k.cpu()[[0, 2]], res_p[[0, 2]], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fmt", [None, tfp.Q1_19], ids=["f32", "Q1.19"])
def test_cuda_fused_iteration_matches_plain(cuda, fmt):
    args, kw = _fused_operands(_prime_graph(seed=4), fmt, 8, p_scale=1 / 100, vm_stride=70)
    before = tfused.fused_ppr_iteration.launches
    P_k, res_k = tfused.fused_ppr_iteration(*(a.to(cuda) for a in args), **kw)
    assert tfused.fused_ppr_iteration.launches == before + 1
    P_p, res_p = tfused.fused_ppr_iteration(*args, **kw)
    _check_fused(P_k, res_k, P_p, res_p, fmt is not None)


def _hub_graph(v=1500, e=9000, hub=3, hub_in=1200, seed=5):
    """A 1,200-edge hub row (38 slices of 32), an empty dst range 1000..1099,
    a ragged last block (1500 = 11·128 + 92) and a dangling tail."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.choice(v - 60, hub_in, replace=False),
                          rng.integers(0, v - 60, e)])
    dst = np.concatenate([np.full(hub_in, hub), rng.integers(0, v, e)])
    dst = np.where((dst >= 1000) & (dst < 1100), dst - 500, dst)
    return COOGraph.from_edges(src, dst, v)


@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
@pytest.mark.parametrize("k", [1, 4, 16, 129, 1024])
@pytest.mark.parametrize("slice_edges", [32, 256], ids=["hub-over-38-slices", "default"])
def test_cuda_stream_kernels_hub_row_and_ragged_block(cuda, fmt, k, slice_edges):
    """Both stream kernels on a skewed graph: K ∈ {1, 4, 16} (one and four
    columns a lane) and K ∈ {129, 1024} (several column passes), a hub row
    across many slices and chunks, empty rows and a ragged last block; fixed
    point raw-bit equal to the plain versions."""
    g = _hub_graph()
    args, kw = _fused_operands(g, fmt, k, slice_edges=slice_edges)
    _check_fused(*tfused.fused_ppr_iteration(*(a.to(cuda) for a in args), **kw),
                 *tfused.fused_ppr_iteration(*args, **kw), fmt is not None)
    stream_args = (args[0], args[1], args[4])
    skw = dict(frac_bits=None if fmt is None else fmt.frac_bits)
    out_k = coo_spmv_kernel(*(a.to(cuda) for a in stream_args), **skw).cpu()
    out_p = coo_spmv_plain(*stream_args, **skw)
    if fmt is None:
        torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-8)
    else:
        assert torch.equal(out_k, out_p)
    assert torch.equal(out_k[1000:1100], torch.zeros_like(out_k[1000:1100]))


def test_cuda_fused_iteration_large_states_over_a_hub_row(cuda):
    """Float states 100x the PPR scale (|P_next| up to tens) over the hub row
    across 38 slices: within rtol 1e-5 + atol 1e-9 of the plain version, and
    within 1e-6 of the largest |P_next| absolutely (float32 rounding of sums
    summed in another order grows with the values)."""
    args, kw = _fused_operands(_hub_graph(), None, 16, slice_edges=32, p_scale=1 / 100)
    P_k, res_k = tfused.fused_ppr_iteration(*(a.to(cuda) for a in args), **kw)
    P_p, res_p = tfused.fused_ppr_iteration(*args, **kw)
    torch.testing.assert_close(P_k.cpu(), P_p, rtol=1e-5, atol=1e-9)
    assert float((P_k.cpu() - P_p).abs().max()) <= 1e-6 * float(P_p.abs().max())
    torch.testing.assert_close(res_k.cpu()[[0, 2]], res_p[[0, 2]], rtol=1e-4, atol=1e-6)
    out_k = coo_spmv_kernel(args[0].to(cuda), args[1].to(cuda), args[4].to(cuda)).cpu()
    torch.testing.assert_close(out_k, coo_spmv_plain(args[0], args[1], args[4]),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
def test_cuda_two_calls_in_a_row_give_the_same_bits(cuda, fmt):
    """The last-CTA folds leave their tickets at 0: a second call (and a
    standalone dangling-mass launch between) gives the same bits, float
    included (every sum runs in a fixed order)."""
    args, kw = _fused_operands(_hub_graph(), fmt, 16, slice_edges=32)
    dev = [a.to(cuda) for a in args]
    P1, res1 = tfused.fused_ppr_iteration(*dev, **kw)
    dm1 = tfused.dangling_mass(dev[4], dev[2], fixed=fmt is not None)
    P2, res2 = tfused.fused_ppr_iteration(*dev, **kw)
    dm2 = tfused.dangling_mass(dev[4], dev[2], fixed=fmt is not None)
    assert torch.equal(P1, P2) and torch.equal(res1, res2) and torch.equal(dm1, dm2)
    dm_p = tfused.dangling_mass_plain(args[4], args[2], fixed=fmt is not None)
    if fmt is None:
        torch.testing.assert_close(dm1.cpu(), dm_p, rtol=1e-5, atol=1e-8)
    else:
        assert torch.equal(dm1.cpu(), dm_p)


# ---------------------------------------------------------------------------
# edge deltas: the fused family's refreshed dst stream on the card
# ---------------------------------------------------------------------------
def _fused_rg(g, device, **kw):
    kw.setdefault("packet", 64)
    kw.setdefault("v_tile", 128)
    rg = FusedRegisteredGraph("g", g, device=device, **kw)
    get_engine("fused_float").prepare(rg)
    get_engine("fused_fixed").prepare(rg, tfp.Q1_25)
    return rg


def _refreshed(g, delta, device, **kw):
    rg = _fused_rg(g, device, **kw)
    rg.apply_delta(delta)
    for key in ("fused_float", "fused_fixed"):
        get_engine(key).on_delta(rg, None)
    return rg


def _all_edges_removed():
    g = COOGraph.from_edges(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]), 5)
    return g, EdgeDelta(remove_src=g.y, remove_dst=g.x)


def _dangling_filled():
    """Every dangling vertex (the tail from 601) gets an out-edge: the
    refreshed dangling list is empty."""
    g = _prime_graph(seed=8)
    tail = np.nonzero(g.dangling)[0]
    return g, EdgeDelta(add_src=tail, add_dst=np.zeros_like(tail))


def _recut():
    """255,990 edges take 32-edge slices, 64 more take 64-edge slices."""
    rng = np.random.default_rng(4)
    g = COOGraph.from_edges(rng.integers(0, 20_000, 255_990),
                            rng.integers(0, 20_000, 255_990), 20_000)
    return g, EdgeDelta(add_src=rng.integers(0, 20_000, 64),
                        add_dst=rng.integers(0, 20_000, 64))


DELTA_CASES = {
    "random": lambda: (_prime_graph(seed=6),
                       random_delta(_prime_graph(seed=6), np.random.default_rng(0),
                                    n_add=40, n_remove=20)),
    "growth": lambda: (_prime_graph(seed=6),
                       random_delta(_prime_graph(seed=6), np.random.default_rng(1),
                                    n_add=10, n_remove=5, grow=130)),
    "dangling_emptied": _dangling_filled,
    "dangling_grows": lambda: (_prime_graph(seed=9), EdgeDelta(
        remove_src=_prime_graph(seed=9).y[:300], remove_dst=_prime_graph(seed=9).x[:300])),
    "all_edges_removed": _all_edges_removed,
    "slices_recut": _recut,
}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_cuda_refresh_equals_fresh_registration_and_kernel_matches_plain(cuda, case):
    """After a delta the card's stream, dangling list and values equal a
    fresh registration's, and kernel 2 on the refreshed stream equals its
    plain version (float32: rtol 1e-5 + atol 1e-9 and 1e-6; Q1.25: raw
    bits) — over a growth delta, one that empties the dangling list, one
    that removes every edge, and one that re-cuts the slices."""
    g, delta = DELTA_CASES[case]()
    kw = dict(packet=256, v_tile=4096) if case == "slices_recut" else {}
    rg = _refreshed(g, delta, cuda, **kw)
    fresh = _fused_rg(rg.source, cuda, **kw)
    topo, ftopo = rg.fused_topology(), fresh.fused_topology()
    for f in ("row_ptr", "col", "nz_rows", "slice_row"):
        assert torch.equal(getattr(topo, f), getattr(ftopo, f)), f
    assert (topo.slice_edges, topo.src_rows) == (ftopo.slice_edges, ftopo.src_rows)
    assert torch.equal(rg.fused_dangling(), fresh.fused_dangling())
    if case == "dangling_emptied":
        assert rg.fused_dangling().numel() == 0
    if case == "all_edges_removed":
        assert topo.num_edges == 0
    if case == "slices_recut":
        assert topo.slice_edges == 64
    v = rg.num_vertices
    rng = np.random.default_rng(2)
    p = torch.from_numpy((rng.random((v, 16)) * 2 / v).astype(np.float32))
    vm = torch.zeros((v, 16))
    vm[torch.arange(16) % v, torch.arange(16)] = 1.0
    for fmt in (None, tfp.Q1_25):
        assert torch.equal(rg.fused_values(fmt), fresh.fused_values(fmt))
        pf, vmf = (p, vm) if fmt is None else (fmt.from_float(p), fmt.from_float(vm))
        cpu_args = (topo.to("cpu"), rg.fused_values(fmt).cpu(),
                    rg.fused_dangling().cpu(), vmf, pf)
        P_k, res_k = tfused.fused_ppr_iteration(
            topo, rg.fused_values(fmt), rg.fused_dangling(), vmf.to(cuda), pf.to(cuda),
            alpha=ALPHA, fmt=fmt)
        _check_fused(P_k, res_k, *tfused.fused_ppr_iteration(*cpu_args, alpha=ALPHA, fmt=fmt),
                     fmt is not None)


def test_cuda_deltas_release_the_old_stream(cuda):
    """Device memory after five refreshes stays within one stream (topology,
    dangling list, f32 and Q1.25 values) of what it was after the first."""
    g = erdos_renyi(20_000, 200_000, seed=3)
    rg = _fused_rg(g, cuda, packet=256, v_tile=512)
    rng = np.random.default_rng(0)

    def one_delta():
        rg.apply_delta(random_delta(rg.source, rng, n_add=256, n_remove=128))
        for key in ("fused_float", "fused_fixed"):
            get_engine(key).on_delta(rg, None)
        torch.cuda.synchronize()

    one_delta()
    base = torch.cuda.memory_allocated(cuda)
    topo = rg.fused_topology()
    stream_bytes = sum(t.numel() * t.element_size() for t in (
        topo.row_ptr, topo.col, topo.nz_rows, topo.slice_row, rg.fused_dangling(),
        rg.fused_values(None), rg.fused_values(tfp.Q1_25)))
    del topo
    for _ in range(5):
        one_delta()
    assert torch.cuda.memory_allocated(cuda) <= base + stream_bytes



# ---------------------------------------------------------------------------
# adaptive precision: the shadow reference's shape and an auto wave
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cols", [1, 3, 16])
def test_cuda_fused_float_plan_on_shadow_shapes_matches_plain(cuda, cols):
    """The shadow reference runs the fused float plan over only the sampled
    columns (1 ≤ K ≤ κ) for the full budget: on the card it equals the same
    plan on the CPU (the plain versions) within 1e-6, every step a kernel
    launch."""
    g = _prime_graph(seed=11)
    pers = np.random.default_rng(cols).choice(g.num_vertices, cols, replace=False)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        rg = FusedRegisteredGraph("g", g, device=dev, packet=64, v_tile=128)
        plan = get_engine("fused_float").plan(rg, None, alpha=ALPHA, iterations=10)
        vmat = plan.initial(torch.as_tensor(pers.astype(np.int32), device=dev))
        before = tfused.fused_ppr_iteration.launches
        p = vmat
        for _ in range(10):
            p = plan.step(vmat, p)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert tfused.fused_ppr_iteration.launches == before + 10
        out[dev.type] = p.cpu()
    assert out["cuda"].shape == (g.num_vertices, cols)
    assert float((out["cuda"] - out["cpu"]).abs().max()) < 1e-6


def test_cuda_auto_wave_fused_equals_single(cuda):
    """An auto wave on the fused family resolves the same precisions, serves
    bit-equal answers and scores the same shadow samples as the single
    family, and its shadow reference launches the kernel."""
    from repro_torch.autotune import AutotuneConfig, ShadowConfig
    from repro_torch.ppr_serving import PPRQuery, PPRService

    g = erdos_renyi(3000, 30000, seed=2)
    verts = np.random.default_rng(5).choice(g.num_vertices, 48, replace=False)
    out = {}
    for engine in ("fused", "single"):
        cfg = AutotuneConfig(ladder=(12, 16, 20), promote_patience=1,
                             shadow=ShadowConfig(sample_fraction=0.5, min_samples=1,
                                                 window=4, seed=1))
        svc = PPRService(kappa=16, iterations=10, autotune=cfg, device=cuda)
        svc.register_graph("g", g, engine=engine)
        before = tfused.fused_ppr_iteration.launches
        recs = svc.run_batch([PPRQuery("g", int(v), precision="auto") for v in verts])
        torch.cuda.synchronize()
        out[engine] = (recs, svc, tfused.fused_ppr_iteration.launches - before)
    (rf, sf, lf), (rs, ss, ls) = out["fused"], out["single"]
    assert [r.precision for r in rf] == [r.precision for r in rs]
    for a, b in zip(rf, rs):
        assert np.array_equal(a.vertices, b.vertices)
        assert np.array_equal(a.scores, b.scores)
    assert sf.controller.summary() == ss.controller.summary()
    assert len(sf.telemetry.shadow_scores) == len(ss.telemetry.shadow_scores) > 0
    assert np.abs(np.asarray(sf.telemetry.shadow_scores)
                  - np.asarray(ss.telemetry.shadow_scores)).max() < 1e-4
    # three waves of 10 iterations, plus one shadow reference of 10 per wave
    # that sampled a fixed-point query
    assert ls == 0 and lf >= 30 + 10 and lf % 10 == 0


# ---------------------------------------------------------------------------
# tracing and the HTTP tier: deepened κ, traced waves, served answers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("graph", ["prime", "hub"])
def test_cuda_fused_iteration_at_deepened_kappa_matches_plain(cuda, fmt, k, graph):
    """K = 32 and 64, the κ the admission controller deepens to: fixed point
    raw-bit equal to the plain version; float32 P_next within rtol 1e-5 +
    atol 1e-9 (and 1e-6) of the plain version run in float64, and the
    residual rows within rtol 1e-4 of the kernel's own P_next's."""
    g = _prime_graph(seed=4) if graph == "prime" else _hub_graph()
    args, kw = _fused_operands(g, fmt, k, p_scale=1 / 100, vm_stride=7)
    P_k, res_k = tfused.fused_ppr_iteration(*(a.to(cuda) for a in args), **kw)
    if fmt is not None:
        _check_fused(P_k, res_k, *tfused.fused_ppr_iteration(*args, **kw), True)
        return
    topo, val, dang, vm, p = args
    P64, _ = tfused.fused_ppr_plain(topo, val.double(), dang, vm.double(), p.double(),
                                    **kw)
    P_k = P_k.cpu().double()
    torch.testing.assert_close(P_k, P64, rtol=1e-5, atol=1e-9)
    assert float((P_k - P64).abs().max()) <= 1e-6
    d = (P_k - p.double()).abs()
    own = torch.stack([d.sum(0), d.amax(0), (d * d).sum(0)])
    torch.testing.assert_close(res_k.cpu().double()[[0, 2]], own[[0, 2]],
                               rtol=1e-4, atol=0.0)
    assert float((res_k.cpu().double()[1] - own[1]).abs().max()) <= 1e-6


@pytest.mark.parametrize("tracing", [True, 0.5], ids=["traced", "sampled"])
def test_cuda_traced_fused_wave_equals_untraced(cuda, tracing):
    """A traced fused wave on the card (early exit armed, so the iterate
    span reads the kernel's residual) serves the answers and iteration
    counts of an untraced one, and its wave traces carry the five spans."""
    from repro_torch.ppr_serving import PPRQuery, PPRService

    g = erdos_renyi(3000, 30000, seed=2)
    verts = np.random.default_rng(9).choice(g.num_vertices, 40, replace=False)
    queries = [PPRQuery("g", int(v), precision=(None, 26)[i % 2])
               for i, v in enumerate(verts)]
    out = {}
    for label, t in (("untraced", False), ("traced", tracing)):
        svc = PPRService(kappa=16, iterations=30, early_exit=True, tracing=t,
                         device=cuda)
        svc.register_graph("g", g, formats=[26], engine="fused")
        before = tfused.fused_ppr_iteration.launches
        recs = svc.run_batch(queries)
        torch.cuda.synchronize()
        out[label] = (recs, svc, tfused.fused_ppr_iteration.launches - before)
    (rt, st, lt), (ru, su, lu) = out["traced"], out["untraced"]
    assert lt == lu > 0
    for a, b in zip(rt, ru):
        assert a.precision == b.precision
        assert np.array_equal(a.vertices, b.vertices)
        if a.precision == "f32":
            assert float(np.abs(a.scores - b.scores).max()) <= 1e-6
        else:
            assert np.array_equal(a.scores, b.scores)
    for key in ("waves", "early_exit_waves", "iterations_saved"):
        assert st.telemetry_summary()[key] == su.telemetry_summary()[key]
    waves = [t for t in st.recorder.traces() if t["kind"] == "wave"]
    assert waves
    for t in waves:
        assert [c["name"] for c in t["root"]["children"]] == [
            "plan", "warm_start", "iterate", "topk", "resolve"]
        it = t["root"]["children"][2]["attrs"]
        assert set(it) == {"iterations_run", "budget", "early_exit", "residual"}
        assert it["budget"] == 30 and it["residual"] is not None


def test_cuda_http_answers_equal_run_batch(cuda):
    """Requests served by ``PPRHTTPServer`` over a fused service on the card
    (waves on the pump's worker thread, κ deepened to 32 and 64 by a tight
    admission config) equal ``run_batch`` on a second fused service at the
    precision each response names; nothing answers 500."""
    import asyncio

    from repro_torch.ppr_serving import PPRQuery, PPRService
    from repro_torch.ppr_serving import http

    g = erdos_renyi(3000, 30000, seed=2)
    svc = PPRService(kappa=16, iterations=10, max_wait=0.005, tracing=0.5, slo=True,
                     device=cuda)
    svc.register_graph("g", g, formats=[26], engine="fused")
    rng = np.random.default_rng(3)
    bodies = [{"graph": "g", "vertex": int(v), "k": 10, "precision": (26, None, "auto")[i % 3]}
              for i, v in enumerate(rng.integers(0, g.num_vertices, 96))]
    server = http.PPRHTTPServer(svc, admission=http.AdmissionConfig(
        high_water=200, low_water=4, deepen_water=4, kappa_max=64))
    before = tfused.fused_ppr_iteration.launches

    async def scenario():
        await server.transport.start()          # the pump held back: κ deepens
        host, port = server.host, server.port
        task = asyncio.gather(*[http.http_request(host, port, "POST", "/v1/ppr", b)
                                for b in bodies])
        while svc.queue_depth() < len(bodies):
            await asyncio.sleep(0.002)
        server.pump.start()
        res = await asyncio.wait_for(task, 120)
        await server.stop()
        return res

    res = asyncio.run(scenario())
    assert tfused.fused_ppr_iteration.launches > before
    assert [r[0] for r in res] == [200] * len(bodies)
    assert 64 in [e["kappa"] for e in svc.recorder.events_of_kind("kappa")]
    mirror = PPRService(kappa=16, iterations=10, device=cuda)
    mirror.register_graph("g", g, formats=[26], engine="fused")
    recs = mirror.run_batch([PPRQuery("g", b["vertex"], k=10,
                                      precision=None if r[2]["precision"] == "f32"
                                      else r[2]["precision"])
                             for b, r in zip(bodies, res)])
    for (_, _, p), rec in zip(res, recs):
        assert p["precision"] == rec.precision
        scores = np.asarray([x["score"] for x in p["recommendations"]])
        if rec.precision == "f32":
            assert float(np.abs(scores - rec.scores).max()) <= 1e-6
        else:
            assert [x["vertex"] for x in p["recommendations"]] == rec.vertices.tolist()
            assert np.array_equal(scores, rec.scores)


# ---------------------------------------------------------------------------
# fixed-budget waves replayed as one CUDA graph (engine/fused.py)
# ---------------------------------------------------------------------------
def _replays():
    return efused.replay_wave.captures, efused.replay_wave.replays


def _eager(plan, Vmat, P0, n=10):
    P = P0
    for _ in range(n):
        P = plan.step(Vmat, P)
    return P


def _vmats(plan, g, n, kappa, cuda, seed=7):
    rng = np.random.default_rng(seed)
    return [plan.initial(torch.as_tensor(
        rng.choice(g.num_vertices, kappa, replace=False).astype(np.int32), device=cuda))
        for _ in range(n)]


@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
@pytest.mark.parametrize("graph", ["erdos_renyi", "hub"])
def test_cuda_replayed_iterate_equals_eager_steps(cuda, fmt, graph):
    """The fused fixed-budget iterate handed its own step bound to ``Vmat``:
    the first wave of a key runs eagerly and captures, later ones replay,
    each equal to ten eager ``plan.step`` calls (raw bits for Q1.25, float32
    bit for bit, the same kernels in the same order); a warm start (P0 ≠
    Vmat) gets a chain of its own; each replay advances ``launches`` by the
    budget; a returned state survives the next replay."""
    g = erdos_renyi(3000, 30000, seed=2) if graph == "erdos_renyi" else _hub_graph()
    rg = _fused_rg(g, cuda)
    plan = get_engine("fused_fixed" if fmt else "fused_float").plan(
        rg, fmt, alpha=ALPHA, iterations=10)
    waves = _vmats(plan, g, 3, 16, cuda)
    c0, r0 = _replays()
    for i, Vmat in enumerate(waves):
        want = _eager(plan, Vmat, Vmat)
        before = tfused.fused_ppr_iteration.launches
        P, n = plan.iterate(functools.partial(plan.step, Vmat), Vmat)
        torch.cuda.synchronize()
        assert n == 10 and torch.equal(P, want)
        assert tfused.fused_ppr_iteration.launches == before + 10
        assert _replays() == (c0 + 1, r0 + i)
    P0 = _eager(plan, waves[0], waves[0], 3)
    for Vmat in waves[1:]:
        P, _ = plan.iterate(functools.partial(plan.step, Vmat), P0)
        torch.cuda.synchronize()
        assert torch.equal(P, _eager(plan, Vmat, P0))
    assert _replays() == (c0 + 2, r0 + 3) and len(rg.fused_chains) == 2
    P_a, _ = plan.iterate(functools.partial(plan.step, waves[0]), waves[0])
    P_b, _ = plan.iterate(functools.partial(plan.step, waves[1]), waves[1])
    torch.cuda.synchronize()
    assert torch.equal(P_a, _eager(plan, waves[0], waves[0]))
    assert torch.equal(P_b, _eager(plan, waves[1], waves[1]))


def test_cuda_each_kappa_gets_its_own_chain(cuda):
    """κ 16 then 32 (the admission controller's deepening) on one graph:
    two chains, each replay equal to the eager steps."""
    g = erdos_renyi(3000, 30000, seed=2)
    rg = _fused_rg(g, cuda)
    plan = get_engine("fused_fixed").plan(rg, tfp.Q1_25, alpha=ALPHA, iterations=10)
    for kappa in (16, 32):
        for Vmat in _vmats(plan, g, 2, kappa, cuda, seed=kappa):
            P, _ = plan.iterate(functools.partial(plan.step, Vmat), Vmat)
            assert torch.equal(P, _eager(plan, Vmat, Vmat))
    assert sorted(key[1] for key in rg.fused_chains) == [16, 32]


def _mixed_queries(g, n, seed):
    from repro_torch.ppr_serving import PPRQuery

    verts = np.random.default_rng(seed).choice(g.num_vertices, n, replace=False)
    return [PPRQuery("g", int(v), k=10, precision=(25, None)[i % 2])
            for i, v in enumerate(verts)]


def _same_answers(got, want):
    for a, b in zip(got, want, strict=True):
        assert (a.query.vertex, a.precision) == (b.query.vertex, b.precision)
        assert np.array_equal(a.vertices, b.vertices)
        assert np.array_equal(a.scores, b.scores)


def test_cuda_replay_after_a_delta_recaptures_and_equals_a_fresh_registration(cuda):
    """A delta drops the graph's chains; the next waves capture anew over the
    refreshed stream and answer as a fresh registration of the merged graph
    does (Q1.25 and float32 bit for bit: array-equal streams, the same
    kernels)."""
    from repro_torch.ppr_serving import PPRService

    g = erdos_renyi(3000, 30000, seed=2)
    svc = PPRService(kappa=16, iterations=10, cache_capacity=0, device=cuda)
    svc.register_graph("g", g, formats=[25], engine="fused")
    svc.run_batch(_mixed_queries(g, 64, seed=1))
    rg = svc.registered_graph("g")
    assert len(rg.fused_chains) == 2                 # Q1.25 and f32, κ 16, cold
    svc.apply_delta("g", random_delta(rg.source, np.random.default_rng(3),
                                      n_add=300, n_remove=100))
    assert rg.fused_chains == {}
    c0, r0 = _replays()
    queries = _mixed_queries(g, 64, seed=2)
    got = svc.run_batch(queries)
    c1, r1 = _replays()
    assert (c1 - c0, r1 - r0) == (2, 2) and len(rg.fused_chains) == 2
    fresh = PPRService(kappa=16, iterations=10, cache_capacity=0, device=cuda)
    fresh.register_graph("g", rg.source, formats=[25], engine="fused")
    _same_answers(got, fresh.run_batch(queries))


def test_cuda_two_threads_serving_at_once_give_the_serial_answers(cuda):
    """Two threads drive waves through one fused service at once (as the
    HTTP pump and ``run_batch`` can), the second on a stream of its own:
    every answer equals the one served serially, and the waves replayed."""
    from repro_torch.ppr_serving import PPRService

    g = erdos_renyi(3000, 30000, seed=2)
    svc = PPRService(kappa=16, iterations=10, cache_capacity=0, device=cuda)
    svc.register_graph("g", g, formats=[25], engine="fused")
    batches = [_mixed_queries(g, 160, seed=s) for s in (4, 5)]
    serial = [svc.run_batch(b) for b in batches]
    _, r0 = _replays()
    out = [None, None]
    start = threading.Barrier(2)

    def serve(i):
        with torch.cuda.stream(torch.cuda.Stream() if i else torch.cuda.current_stream()):
            start.wait()
            out[i] = [svc.run_batch(batches[i]) for _ in range(3)]

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 1):
        for got in out[i]:
            _same_answers(got, serial[i])
    assert _replays()[1] > r0


def test_cuda_early_exit_service_never_replays(cuda):
    """An ``early_exit=True`` fused service runs its waves eagerly: no
    capture, no replay, no chain, and the kernels launch."""
    from repro_torch.ppr_serving import PPRService

    g = erdos_renyi(3000, 30000, seed=2)
    svc = PPRService(kappa=16, iterations=30, early_exit=True, cache_capacity=0,
                     device=cuda)
    svc.register_graph("g", g, formats=[25], engine="fused")
    before, launches = _replays(), tfused.fused_ppr_iteration.launches
    svc.run_batch(_mixed_queries(g, 64, seed=6))
    torch.cuda.synchronize()
    assert _replays() == before and svc.registered_graph("g").fused_chains == {}
    assert tfused.fused_ppr_iteration.launches > launches


# ---------------------------------------------------------------------------
# top-K selection (csrc/topk_select.cu) against the plain sort
# ---------------------------------------------------------------------------
TOPK_ROWS = {"KMAX": tsel.KMAX, "97": 97, "4099": 4099, "2e5": 200_000, "2^20": 1 << 20}


def _no_sort(*args, **kwargs):
    raise AssertionError("a CUDA top-K reached torch.sort")


def _plain_top(P_cpu, full, k, ex):
    """The plain ``topk_dense(P_cpu, k, exclude=ex)`` as numpy (raw values
    as uint32): called as it is up to 4,099 rows; at 2e5 and 2^20 rows read
    off ``full``, that function's top min(TOPK_DEEP + 1, V) of the same
    columns, with the excluded vertex deleted, so that a case sorts P once."""
    if P_cpu.shape[0] <= 4099:
        i, v = topk_dense(P_cpu, k, exclude=None if ex is None else torch.from_numpy(ex))
    else:
        i, v = full
        if ex is not None:
            order = torch.sort((i == torch.from_numpy(ex)[:, None]).to(torch.int8),
                               dim=1, stable=True).indices
            i, v = torch.gather(i, 1, order), torch.gather(v, 1, order)
        i, v = i[:, :k], v[:, :k]
    v = v.numpy()
    return i.numpy(), v.view(np.uint32) if v.dtype == np.int32 else v


def _kernel_top(P_dev, k, ex_dev):
    """``topk_dense`` on the card through the kernel: no synchronising call,
    no ``torch.sort``, one launch a pass of at most KMAX entries."""
    before = tsel.topk_select.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "sort", _no_sort)
        torch.cuda.set_sync_debug_mode("error")
        try:
            i, v = topk_dense(P_dev, k, exclude=ex_dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert tsel.topk_select.launches == before + -(-k // tsel.KMAX)
    v = v.cpu().numpy()
    return i.cpu().numpy(), v.view(np.uint32) if v.dtype == np.int32 else v


TOPK_DEEP = 2 * tsel.KMAX + 3          # three passes


@pytest.mark.parametrize("raw", [False, True], ids=["f32", "Q1.25"])
@pytest.mark.parametrize("rows", list(TOPK_ROWS))
@pytest.mark.parametrize("kappa", [16, 32, 64])
def test_cuda_topk_select_equals_the_plain_sort(cuda, kappa, rows, raw):
    """k of 1, 10, 32, KMAX - 1 and KMAX, and in passes KMAX + 1, 2·KMAX + 3 and
    every vertex, the exclusion absent, inside each column's top and outside
    the graph, on columns with heavy ties, all zeros, fewer nonzeros than k,
    ties at the top and (float32) signed zeros or (Q1.25) raw values at and
    above 2^31: ids and score bits equal the plain version's."""
    v = TOPK_ROWS[rows]
    P = rank_columns(v, kappa, raw, seed=kappa + v)
    P_cpu = torch.from_numpy(P.view(np.int32) if raw else P)
    P_dev = P_cpu.to(cuda)
    full = topk_dense(P_cpu, min(TOPK_DEEP + 1, v))
    # inside: each column's entry at rank j % 12; outside: -1 or V
    inside = full[0].numpy()[np.arange(kappa), np.arange(kappa) % 12].astype(np.int32)
    outside = np.where(np.arange(kappa) % 2, -1, v).astype(np.int32)
    for ex in (None, inside, outside):
        ex_dev = None if ex is None else torch.from_numpy(ex).to(cuda)
        most = v - (ex is not None)
        ks = (1, 10, 32, tsel.KMAX - 1, tsel.KMAX, tsel.KMAX + 1, TOPK_DEEP)
        ks += (most,) if v <= 4099 else ()
        for k in sorted({k for k in ks if k <= most}):
            got_i, got_v = _kernel_top(P_dev, k, ex_dev)
            want_i, want_v = _plain_top(P_cpu, full, k, ex)
            assert np.array_equal(got_i, want_i), (k, ex is None)
            assert np.array_equal(got_v.view(np.uint32), want_v.view(np.uint32)), k


def test_cuda_served_waves_select_top_k_in_the_kernel(cuda):
    """Every wave of the fused and the single family launches the selection
    kernel once; their Q1.25 answers are equal."""
    from repro_torch.ppr_serving import PPRService

    g = erdos_renyi(3000, 30000, seed=2)
    queries = _mixed_queries(g, 96, seed=7)
    out = {}
    for engine in ("fused", "single"):
        svc = PPRService(kappa=16, iterations=10, cache_capacity=0, device=cuda)
        svc.register_graph("g", g, formats=[25], engine=engine)
        svc.run_batch(queries[:16])
        svc.telemetry.reset()
        launches = tsel.topk_select.launches
        out[engine] = svc.run_batch(queries)
        assert tsel.topk_select.launches - launches == svc.telemetry_summary()["waves"] > 0
    fixed = [(a, b) for a, b in zip(out["fused"], out["single"]) if a.precision != "f32"]
    assert fixed
    _same_answers(*zip(*fixed))


# flash attention: float32 to 1e-4 (the kernel and the plain version sum in
# other orders, both in float32); bfloat16 to one bf16 ulp, rtol 2^-7 with
# atol 1e-3 near 0 (both compute in float32 from the same bf16 inputs and
# round the output to bf16 once, so the two may land one ulp apart)
ATTN_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2 ** -7, atol=1e-3)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,window", [
    (2, 128, 128, 4, 1, 64, True, 0),       # MQA, causal
    (1, 256, 256, 8, 4, 256, True, 64),     # GQA, gemma-2b/3 head_dim, window
    (1, 128, 256, 2, 2, 32, False, 0),      # cross-attention-like
    (1, 100, 70, 2, 1, 128, True, 0),       # ragged tiles
    (2, 256, 128, 2, 1, 32, False, 64),     # rows 191-255 fully masked
], ids=["mqa-causal", "gqa-window", "noncausal", "ragged", "fully-masked"])
def test_cuda_flash_attention_matches_plain(cuda, dtype, b, sq, skv, h, kvh, d,
                                            causal, window):
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
               for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    before = flash_attention_gqa.launches
    got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal,
                              window=window, bq=1, bk=1)
    torch.cuda.synchronize()
    assert flash_attention_gqa.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = flash_attention_gqa_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.cpu().float(), want.float(), **ATTN_TOL[dtype])
    if window and not causal:
        assert torch.equal(got.cpu()[:, 191:], torch.zeros_like(got.cpu()[:, 191:]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 512), (128, 256, 128),
                                   (72, 136, 200)])
def test_cuda_quantized_matmul_matches_plain(cuda, dtype, m, k, n):
    """The reference's three shapes and one that no tile divides; rtol = atol
    = 1e-4 (float32 accumulation in another order)."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(m + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dt)
    qt = quantize_weights(torch.from_numpy((rng.standard_normal((k, n)) * 0.05)
                                           .astype(np.float32)))
    tiles = dict(bm=8, bn=8, bk=8)
    before = tops.quantized_matmul_kernel.launches
    got = tops.quantized_matmul(a.to(cuda), qt.q.to(cuda), qt.scale.to(cuda), **tiles)
    torch.cuda.synchronize()
    assert tops.quantized_matmul_kernel.launches == before + 1
    torch.testing.assert_close(got.cpu(), quantized_matmul_plain(a, qt.q, qt.scale),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [32, 64, 96, 128, 160, 192, 224, 256])
def test_cuda_flash_bf16_every_head_dim(cuda, d):
    """The tensor-core kernel at every head_dim it takes (one instantiation
    each): causal GQA over ragged lengths (no tile divides 200 or 136)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16) for shape in ((2, 200, 4, d), (2, 136, 2, d),
                                                  (2, 136, 2, d)))
    before = flash_attention_gqa.launches
    got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda), causal=True, bq=1, bk=1)
    torch.cuda.synchronize()
    assert flash_attention_gqa.launches == before + 1
    want = flash_attention_gqa_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.cpu().float(), want.float(), **ATTN_TOL["bf16"])


@pytest.mark.parametrize("window", [0, 300])
def test_cuda_flash_bf16_d256_causal_gqa_long(cuda, window):
    """gemma's head_dim 256, causal GQA (8 heads over 2) at S = 1024: many kv
    tiles through the ring, diagonal and window tiles skipped per
    warpgroup."""
    rng = np.random.default_rng(1024 + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16) for shape in ((1, 1024, 8, 256), (1, 1024, 2, 256),
                                                  (1, 1024, 2, 256)))
    before = flash_attention_gqa.launches
    got = flash_attention_gqa(q.to(cuda), k.to(cuda), v.to(cuda), causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_gqa.launches == before + 1
    want = flash_attention_gqa_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.cpu().float(), want.float(), **ATTN_TOL["bf16"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(128, 4096, 256), (72, 2048, 200)])
def test_cuda_quantized_matmul_split_k(cuda, dtype, m, k, n):
    """Shapes whose few output tiles engage the K split: within rtol = atol
    = 1e-4 of the plain version, one launch a call, and the same bits on a
    second call (the fold runs in split order; its tickets return to 0)."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dt)
    qt = quantize_weights(torch.from_numpy((rng.standard_normal((k, n)) * 0.05)
                                           .astype(np.float32)))
    args = (a.to(cuda), qt.q.to(cuda), qt.scale.to(cuda))
    assert plan_splits(m, n, k, K_STEP[dt], cta_slots(args[0].device, dtype == "bf16")) > 1
    before = tops.quantized_matmul_kernel.launches
    got = tops.quantized_matmul(*args, bm=8, bn=8, bk=8)
    again = tops.quantized_matmul(*args, bm=8, bn=8, bk=8)
    torch.cuda.synchronize()
    assert tops.quantized_matmul_kernel.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), quantized_matmul_plain(a, qt.q, qt.scale),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the sharded path: coo_spmv over shard streams, the meshed service
# ---------------------------------------------------------------------------
def _shard_streams(g, s):
    from repro_torch.core.spmv import partition_edges_by_dst, sharded_vertex_layout

    x, y, val = (a.reshape(s, -1) for a in partition_edges_by_dst(
        g.x, g.y, g.val, g.num_vertices, s))
    v_local, _ = sharded_vertex_layout(g.num_vertices, s)
    return [build_dst_stream((x[i], y[i], val[i], v_local)) for i in range(s)]


def _check_shard_kernel(cuda, st, p, fmt):
    """The kernel over one shard stream against its plain version: raw bits
    equal, float32 within rtol 1e-5 + atol 1e-9 of the plain version run in
    float64."""
    topo, val = st.topology("cpu"), st.values("cpu", fmt)
    fb = None if fmt is None else fmt.frac_bits
    out_k = coo_spmv_kernel(topo.to(cuda), val.to(cuda), p.to(cuda), frac_bits=fb).cpu()
    assert out_k.shape == (st.num_rows, p.shape[1])
    if fmt is None:
        want = coo_spmv_plain(topo, val.double(), p.double())
        torch.testing.assert_close(out_k.double(), want, rtol=1e-5, atol=1e-9)
    else:
        assert torch.equal(out_k, coo_spmv_plain(topo, val, p, frac_bits=fb))
    return out_k


@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
@pytest.mark.parametrize("k", [1, 3, 16, 64])
def test_cuda_shard_streams_match_plain(cuda, fmt, k):
    """Every shard of the hub graph over 3 shards (a short last shard) and 30
    (shards 20 and 21 cover the empty range 1000..1099 and have no edge): each
    shard's kernel output against its plain version, and the gathered rows
    against the whole graph's plain SpMV."""
    from repro_torch.core.spmv import spmv_fixed, spmv_float

    g = _hub_graph()
    rng = np.random.default_rng(k)
    p = torch.from_numpy((rng.random((g.num_vertices, k)) * 2 / g.num_vertices)
                         .astype(np.float32))
    if fmt is not None:
        p = fmt.from_float(p)
    for s in (3, 30):
        streams = _shard_streams(g, s)
        assert s == 3 or streams[20].num_edges == streams[21].num_edges == 0
        out = torch.cat([_check_shard_kernel(cuda, st, p, fmt) for st in streams])
        x, y = torch.from_numpy(g.x), torch.from_numpy(g.y)
        if fmt is None:
            want = spmv_float(x, y, torch.from_numpy(g.val).double(), p.double(),
                              g.num_vertices)
            torch.testing.assert_close(out[:g.num_vertices].double(), want,
                                       rtol=1e-5, atol=1e-9)
        else:
            val = torch.from_numpy(g.quantized_val(fmt).view(np.int32))
            assert torch.equal(out[:g.num_vertices],
                               spmv_fixed(x, y, val, p, g.num_vertices, fmt))


@pytest.mark.parametrize("fmt", [None, tfp.Q1_25], ids=["f32", "Q1.25"])
def test_cuda_zero_edge_shard_comes_back_zero(cuda, fmt):
    """A shard stream with rows and no edge, its output allocated over
    memory left full of ones: every row comes back 0."""
    from repro_torch.kernels.dst_stream import build_dst_stream

    st = build_dst_stream((np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.float32), 5000))
    assert (st.num_edges, st.num_slices) == (0, 1)
    p = torch.ones((40, 16), dtype=torch.float32 if fmt is None else torch.int32)
    for _ in range(3):
        junk = torch.full((5000 * 16,), -1, dtype=torch.int32, device=cuda)
        del junk
        out = _check_shard_kernel(cuda, st, p, fmt)
        assert not out.any()


def test_cuda_hub_shard_matches_plain(cuda):
    """pl_2e5's hub shard at the test's size: a 4-shard layout of a power-law
    graph puts most edges and the hub rows in shard 0; Q1.25 raw-bit equal,
    float32 at the float64 plain version's limits."""
    from repro_torch.graphs import holme_kim_powerlaw

    g = holme_kim_powerlaw(20000, m=4, seed=1)
    streams = _shard_streams(g, 4)
    assert streams[0].num_edges == max(st.num_edges for st in streams)
    assert int(np.diff(streams[0].row_ptr).max()) > 1000
    rng = np.random.default_rng(2)
    p = torch.from_numpy((rng.random((g.num_vertices, 16)) * 2 / g.num_vertices)
                         .astype(np.float32))
    for fmt in (None, tfp.Q1_25):
        for st in streams:
            _check_shard_kernel(cuda, st, p if fmt is None else fmt.from_float(p), fmt)


def _meshed_and_fused(cuda, g, mesh, queries, **svc_kw):
    from repro_torch.ppr_serving import PPRService

    out = {}
    for name, kw in (("sharded", dict(mesh=mesh)), ("fused", dict(engine="fused"))):
        svc = PPRService(kappa=16, iterations=10, device=cuda, **svc_kw)
        svc.register_graph("g", g, formats=[26], **kw)
        before = coo_spmv_kernel.launches
        recs = svc.run_batch(queries)
        torch.cuda.synchronize()
        out[name] = (recs, svc, coo_spmv_kernel.launches - before)
    return out


def _check_meshed_equal_fused(out, s):
    (rm, sm, lm), (rf, _, lf) = out["sharded"], out["fused"]
    for a, b in zip(rm, rf):
        assert np.array_equal(a.vertices, b.vertices)
        if a.precision == "f32":
            assert np.abs(a.scores - b.scores).max() <= 1e-6
        else:
            assert np.array_equal(a.scores, b.scores)
    waves = sm.telemetry_summary()[f"waves_mesh:shardx{s}"]
    assert lf == 0 and lm == waves * 10 * s


def test_cuda_meshed_service_equals_fused(cuda):
    """A 4-shard mesh on the card (every shard on the cards there are, wrapped)
    serves Q1.25 raw-equal and float32 within 1e-6 of the fused family, top-K
    identical, each iteration one coo_spmv launch a shard."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import PPRQuery

    g = erdos_renyi(3000, 30000, seed=2)
    verts = np.random.default_rng(7).choice(g.num_vertices, 32, replace=False)
    queries = ([PPRQuery("g", int(v), precision=26) for v in verts]
               + [PPRQuery("g", int(v)) for v in verts[:16]])
    mesh = make_mesh((4,), ("shard",), device=cuda)
    _check_meshed_equal_fused(_meshed_and_fused(cuda, g, mesh, queries), 4)


def test_cuda_mesh_across_two_cards(cuda):
    """A 2-shard mesh over two cards: P copied to the second card, its rows
    gathered back to the first, answers equal to the fused family's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the shards then sit on different cards "
                    "and P and the rows cross between them")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import PPRQuery

    g = erdos_renyi(3000, 30000, seed=2)
    verts = np.random.default_rng(8).choice(g.num_vertices, 16, replace=False)
    queries = ([PPRQuery("g", int(v), precision=26) for v in verts]
               + [PPRQuery("g", int(v)) for v in verts])
    mesh = make_mesh((2,), ("shard",), device=cuda)
    assert mesh.placement == "cuda:0×1, cuda:1×1"
    _check_meshed_equal_fused(_meshed_and_fused(cuda, g, mesh, queries), 2)


# ---------------------------------------------------------------------------
# LM families: MoE dispatch, the SSD scan and the rolling window cache
# ---------------------------------------------------------------------------
def _moe_cfg(cap_factor):
    import dataclasses

    from repro_torch.configs import get_config, smoke_config

    return dataclasses.replace(smoke_config(get_config("mixtral-8x7b")), num_experts=8,
                               moe_capacity_factor=cap_factor, compute_dtype="float32")


@pytest.mark.parametrize("cap_factor", [1.25, 0.5])
def test_cuda_moe_dispatch_equals_cpu(cuda, cap_factor):
    """The card's routing equals the CPU's, and its COO dispatch of the same
    gates (stable sort by expert, ranks, capacity cut) is array-equal to the
    CPU's; at 0.5 tokens are dropped.  moe_ffn in float32 within 2e-4 / 2e-5
    of the same routing run in float64 (``tests/test_moe.py``), and within
    1e-5 of the CPU's."""
    from repro_torch.models import moe as tmoe

    cfg = _moe_cfg(cap_factor)
    p = tmoe.MoE(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    pc = {k: v.to(cuda) for k, v in p.items()}
    cap = tmoe._capacity(64, cfg, cap_factor)
    val, idx = tmoe.route(x.to(cuda), pc["router"], cfg)
    val_c, idx_c = tmoe.route(x, p["router"], cfg)
    assert torch.equal(idx.cpu(), idx_c)
    torch.testing.assert_close(val.cpu(), val_c, rtol=1e-5, atol=1e-6)
    got = tmoe.dispatch(idx, val, cap, cfg.num_experts, torch.float32)
    want = tmoe.dispatch(idx.cpu(), val.cpu(), cap, cfg.num_experts, torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if cap_factor < 1:
        assert int((want[0] == cfg.num_experts * cap).sum()) > 0
    slot, ts, gs = got
    out = tmoe.moe_ffn(x.to(cuda), pc, cfg)
    p64 = {k: v.double() for k, v in pc.items()}
    out64 = tmoe.combine(tmoe.experts(x.to(cuda).double(), p64, cfg, cap, slot, ts),
                         slot, ts, gs.double(), 64)
    torch.testing.assert_close(out.double(), out64, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(out.cpu(), tmoe.moe_ffn(x, p, cfg), rtol=1e-5, atol=1e-6)


def test_cuda_ssd_chunked_matches_float64_scan(cuda):
    """``ssd_chunked`` in float32 on the card against the step-by-step
    recurrence in float64 on the card, at rtol = atol = 2e-4
    (``tests/test_ssd.py``): 4 chunks of 128, 8 heads of 16, state 32."""
    from repro_torch.models.ssm import ssd_chunked

    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 512, 8, 16, 32
    x = rng.standard_normal((b, s, h, p))
    dt = rng.random((b, s, h)) * 0.5
    A = -rng.random(h)
    B = rng.standard_normal((b, s, 1, n))
    C = rng.standard_normal((b, s, 1, n))
    args = [torch.from_numpy(a).to(cuda) for a in (x, dt, A, B, C)]
    y, final = ssd_chunked(*(a.float() for a in args), 128)
    x, dt, A, B, C = args
    state = torch.zeros((b, h, p, n), dtype=torch.float64, device=cuda)
    ys = torch.zeros((b, s, h, p), dtype=torch.float64, device=cuda)
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None])
        state = (state * decay[..., None, None]
                 + (dt[:, t][..., None] * x[:, t])[..., None]
                 * B[:, t].repeat_interleave(h, 1)[:, :, None, :])
        ys[:, t] = torch.einsum("bhpn,bhn->bhp", state, C[:, t].repeat_interleave(h, 1))
    torch.testing.assert_close(y.double(), ys, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(final.double(), state, rtol=2e-4, atol=2e-4)


def test_cuda_windowed_decode_matches_full_cache(cuda):
    """gemma3's smoke width with windows of 4 on the card: prefill 10, then 8
    decode steps through rolling buffers (they wrap) equal the full cache's
    logits within rtol 2e-4 / atol 2e-5 (``tests/test_windowed_cache.py``)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(smoke_config(get_config("gemma3-4b")), compute_dtype="float32")
    cfg = dataclasses.replace(cfg, layer_pattern=tuple(4 if w else w for w in cfg.layer_pattern))
    api = build_model(cfg, device=cuda)
    params = api.init_params(torch.Generator(cuda).manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 18)).astype(np.int32)

    def run(window_cache):
        cache = api.init_cache(2, 32, window_cache=window_cache)
        logits, cache = api.prefill(params, {"tokens": toks[:, :10]}, cache)
        outs = [logits]
        for t in range(10, 18):
            logits, cache = api.decode_step(params, toks[:, t:t + 1], t, cache)
            outs.append(logits)
        return outs, cache

    full, _ = run(False)
    win, cache = run(True)
    assert all(c["k"].shape[1] == 4 and c["k"].device.type == cuda.type for c in cache)
    for t, (a, b) in enumerate(zip(full, win)):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5, msg=f"step {t}")


# ---------------------------------------------------------------------------
# encdec, vlm and training on the card
# ---------------------------------------------------------------------------
def _smoke32(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_config, smoke_config

    return dataclasses.replace(smoke_config(get_config(arch)), compute_dtype="float32", **kw)


@pytest.mark.parametrize("arch", ["whisper-medium", "phi-3-vision-4.2b"])
def test_cuda_encdec_vlm_decode_matches_forward(cuda, arch):
    """whisper (frames) and phi-3-vision (patches) on the card: prefill's
    last logits and 4 decode steps against teacher-forced forward within
    rtol 2e-3 / atol 2e-4 (``tests/test_models_smoke.py:71``), and each
    within 1e-5 of the same model on the CPU."""
    from repro_torch.models import build_model

    cfg = _smoke32(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    extra = {}
    if cfg.enc_len:
        extra["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        extra["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    p = cfg.num_patches
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        api = build_model(cfg, device=dev)
        params = api.init_params(torch.Generator().manual_seed(0)).to(dev)
        full = api.forward(params, dict(extra, tokens=toks))
        logits, cache = api.prefill(params, dict(extra, tokens=toks[:, :10]),
                                    api.init_cache(2, 32))
        steps = [logits]
        torch.testing.assert_close(logits, full[:, p + 9], rtol=2e-3, atol=2e-4)
        for t in range(10, 14):
            logits, cache = api.decode_step(params, toks[:, t:t + 1], p + t, cache)
            torch.testing.assert_close(logits, full[:, p + t], rtol=2e-3, atol=2e-4)
            steps.append(logits)
        outs[dev.type] = steps
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_cuda_train_step_equals_cpu(cuda, microbatches):
    """One train step of gemma-2b's smoke widths (2 layers, float32, remat)
    on the card against the same step on the CPU: loss rtol 1e-5, μ rtol
    1e-4 / atol 1e-8, ν rtol 1e-4 / atol 1e-10, parameters rtol 2e-4 / atol
    2e-5 (``tests/test_train.py:57``) except where √v̂ < 1e-6, Adam's
    ill-conditioned direction, held to 2.5·lr."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    cfg = _smoke32("gemma-2b", num_layers=2, layer_pattern=(0, 0))
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        api = build_model(cfg, device=dev, remat=True)
        params = api.init_params(torch.Generator().manual_seed(0)).to(dev)
        step = make_train_step(api.loss_fn, opt, microbatches=microbatches)
        out[dev.type] = step(init_train_state(params),
                             synthetic_batch(cfg, DataConfig(16, 4), 0, device=dev))
    (gs, gm), (ws, wm) = out["cuda"], out["cpu"]
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-5)
    want = dict(ws.params.named_parameters())
    for n, p in gs.params.named_parameters():
        torch.testing.assert_close(gs.opt.mu[n].cpu(), ws.opt.mu[n], rtol=1e-4, atol=1e-8)
        torch.testing.assert_close(gs.opt.nu[n].cpu(), ws.opt.nu[n], rtol=1e-4, atol=1e-10)
        ill = torch.sqrt(ws.opt.nu[n] / (1 - opt.b2)) < 1e-6
        d = (p.detach().cpu() - want[n].detach()).abs()
        off = d > 2e-5 + 2e-4 * want[n].detach().abs()
        assert not (off & ~ill).any(), n
        assert (d[off] <= 2.5 * opt.lr).all(), n


def test_cuda_resume_equals_uninterrupted(cuda, tmp_path):
    """``run_resumable`` on the card: a failure at step 4 after the
    checkpoint at step 3, then a resume, ends within rtol 2e-4 / atol 2e-5
    of an uninterrupted run of 6 steps.  The embedding's backward sums by
    atomics, so the runs need not be bit-equal, and where √v̂ < 1e-6 Adam's
    direction is ill-conditioned: there each step may move a parameter by
    up to 2.5·lr apart."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.training import (
        AdamWConfig,
        FaultConfig,
        init_train_state,
        make_train_step,
        run_resumable,
    )

    cfg = _smoke32("gemma-2b", num_layers=2, layer_pattern=(0, 0))
    api = build_model(cfg, device=cuda)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(api.loss_fn, opt)

    def init():
        return init_train_state(api.init_params(torch.Generator(cuda).manual_seed(0)))

    def batch_fn(s):
        return synthetic_batch(cfg, DataConfig(16, 4), s, device=cuda)

    ref = init()
    for s in range(6):
        ref, _ = step(ref, batch_fn(s))
    fault = FaultConfig(ckpt_dir=str(tmp_path), save_every=3, max_steps=6)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        run_resumable(fault, init, step, batch_fn, fail_at_step=4)
    state, steps_run, _ = run_resumable(fault, init, step, batch_fn)
    assert steps_run == 3 and int(state.opt.step) == 6
    got = dict(state.params.named_parameters())
    for n, a in ref.params.named_parameters():
        d = (got[n] - a).abs().detach()
        off = d > 2e-5 + 2e-4 * a.detach().abs()
        ill = torch.sqrt(ref.opt.nu[n] / (1 - opt.b2 ** 6)) < 1e-6
        assert not (off & ~ill).any(), n
        assert (d[off] <= 2.5 * opt.lr * 6).all(), n


# ---------------------------------------------------------------------------
# the sharding hooks, the compressed all-reduce and restore(shardings=) on a
# one-rank NCCL group (one card: a 1×1 mesh, every layout the same)
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_mesh(cuda):
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b", "mamba2-1.3b"])
def test_cuda_sharded_train_step_equals_unsharded(nccl_mesh, arch):
    """Smoke size, float32: the loss, every gradient and the parameters after
    one AdamW step with the parameters as DTensors under a sharding context
    equal the unsharded step's on the card, bit for bit."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import build_model
    from repro_torch.training import AdamWConfig
    from repro_torch.training.optimizer import adamw_update, init_opt_state

    cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype="float32")
    api = build_model(cfg, device="cuda", remat=True)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             .cuda() for k in ("tokens", "targets")}

    def step(params, bt):
        loss = api.loss_fn(params, bt)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        adamw_update(AdamWConfig(lr=1e-3, warmup_steps=1), grads, init_opt_state(params),
                     params)
        return loss.detach(), grads

    def fresh():
        return api.init_params(torch.Generator("cuda").manual_seed(0)).requires_grad_(True)

    want_params = fresh()
    want_loss, want_grads = step(want_params, batch)
    params = shd.distribute_params(fresh(), nccl_mesh, cfg)
    dbatch = {k: shd.distribute(v, nccl_mesh, ("data",)) for k, v in batch.items()}
    shd.set_sharding_context(nccl_mesh)
    try:
        with implicit_replication():
            loss, grads = step(params, dbatch)
    finally:
        shd.set_sharding_context(None)
    assert torch.equal(loss.full_tensor(), want_loss)
    for n, w in want_params.named_parameters():
        assert torch.equal(grads[n].full_tensor(), want_grads[n]), n
        assert torch.equal(params.get_parameter(n).full_tensor().detach(), w.detach()), n


def test_cuda_compressed_psum_and_sharded_restore(nccl_mesh, tmp_path):
    from torch.distributed.tensor import Replicate

    from repro_torch.core.quantization import truncate_to_grid
    from repro_torch.distributed.collectives import (
        compressed_psum,
        make_compressed_grad_allreduce,
    )
    from repro_torch.training import checkpoint

    gen = torch.Generator("cuda").manual_seed(0)
    grads = {"a": torch.randn((64, 32), generator=gen, device="cuda") * 0.1,
             "b": torch.randn((7,), generator=gen, device="cuda")}
    res = {k: torch.randn(g.shape, generator=gen, device="cuda") * 2.0 ** -14
           for k, g in grads.items()}
    red, new = make_compressed_grad_allreduce(nccl_mesh, "data", 12)(grads, res)
    for k, g in grads.items():
        q = truncate_to_grid(g + res[k], 12)
        assert torch.equal(red[k], q) and torch.equal(new[k], (g + res[k]) - q)
        one = compressed_psum(g, res[k], "model", 12, mesh=nccl_mesh)
        assert torch.equal(one[0], q) and torch.equal(one[1], new[k])
    checkpoint.save(str(tmp_path), 1, grads)
    like = {k: torch.zeros_like(g) for k, g in grads.items()}
    got = checkpoint.restore(str(tmp_path), 1, like, shardings={
        "a": (nccl_mesh, [Replicate(), Replicate()]), "b": None})
    assert torch.equal(got["a"].full_tensor(), grads["a"]) and got["a"].device.type == "cuda"
    assert torch.equal(got["b"], grads["b"])
