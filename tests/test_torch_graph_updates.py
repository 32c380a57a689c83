"""Port parity, graph updates: the edge-delta merge, ``EdgeDelta`` and its
generators, the warm-start store, the registered graphs' delta refresh (the
fused family's dirty-block re-packetization and rebuilt dst stream) and
``PPRService.apply_delta`` / ``warm_start`` against the JAX reference.

Every test feeds both packages the same numpy inputs, made from a seed.  The
reference's service runs its "single" family (XLA, no Pallas call): its own
``test_service_end_to_end_bit_identical`` holds that family bit-identical to
its Pallas one.  Tolerances: the merge, the layouts, the dst stream and
every fixed-point state or score are compared for equality (raw bits);
float32 scores within 1e-6 (``tests/test_pallas_engine.py:73``).
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.coo import COOGraph  # noqa: E402
from repro.core.coo import merge_edge_delta as rmerge  # noqa: E402
from repro.core.fixed_point import format_for_bits  # noqa: E402
from repro.graph_updates import EdgeDelta as REdgeDelta  # noqa: E402
from repro.graph_updates import WarmStartStore as RWarm  # noqa: E402
from repro.graph_updates import localized_delta as rlocalized  # noqa: E402
from repro.graph_updates import random_delta as rrandom  # noqa: E402
from repro.graphs import holme_kim_powerlaw  # noqa: E402
from repro.ppr_serving import PallasRegisteredGraph  # noqa: E402
from repro.ppr_serving import PPRQuery as RQuery  # noqa: E402
from repro.ppr_serving import PPRService as RService  # noqa: E402
from repro.ppr_serving.graphs import RegisteredGraph as RRegistered  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core.coo import merge_edge_delta as tmerge  # noqa: E402
from repro_torch.core.fixed_point import format_for_bits as tformat_for_bits  # noqa: E402
from repro_torch.graph_updates import EdgeDelta as TEdgeDelta  # noqa: E402
from repro_torch.graph_updates import WarmStartStore as TWarm  # noqa: E402
from repro_torch.graph_updates import localized_delta as tlocalized  # noqa: E402
from repro_torch.graph_updates import random_delta as trandom  # noqa: E402
from repro_torch.kernels.dst_stream import build_dst_stream  # noqa: E402
from repro_torch.kernels.fused_ppr import build_fused_layout  # noqa: E402
from repro_torch.ppr_serving import FusedRegisteredGraph  # noqa: E402
from repro_torch.ppr_serving import PPRQuery as TQuery  # noqa: E402
from repro_torch.ppr_serving import PPRService as TService  # noqa: E402
from repro_torch.ppr_serving import QueryRejected, Wave  # noqa: E402
from repro_torch.ppr_serving import get_engine as tget  # noqa: E402
from repro_torch.ppr_serving.graphs import RegisteredGraph as TRegistered  # noqa: E402

CPU = "cpu"
V_PRIME = 641
FLOAT_TOL = 1e-6                   # float32 scores, tests/test_pallas_engine.py:73
INFO_FIELDS = ("kept_old_idx", "new_pos_of_kept", "changed_mask", "touched_sources",
               "changed_dst", "new_outdeg", "num_added", "num_removed")
STREAM_FIELDS = ("row_ptr", "col", "nz_rows", "slice_row")
LAYOUT_FIELDS = ("x2", "y2", "val2", "step_row", "step_dst", "step_src",
                 "step_first", "step_last")


@pytest.fixture(scope="module")
def graph():
    return holme_kim_powerlaw(400, m=4, seed=2)       # tests/test_graph_updates.py:27


def _prime_graph(v=V_PRIME, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    # sources capped below v-40 ⇒ the tail vertices are dangling
    return COOGraph.from_edges(rng.integers(0, v - 40, e), rng.integers(0, v, e), v)


def _port(g):
    return graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices)


def _tdelta(d):
    return TEdgeDelta(add_src=d.add_src, add_dst=d.add_dst, remove_src=d.remove_src,
                      remove_dst=d.remove_dst, new_num_vertices=d.new_num_vertices)


def _assert_graphs_equal(a, b):
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(np.asarray(a.val).view(np.uint32),
                                  np.asarray(b.val).view(np.uint32))
    np.testing.assert_array_equal(a.dangling, b.dangling)


def _assert_deltas_equal(a, b):
    for f in ("add_src", "add_dst", "remove_src", "remove_dst"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.new_num_vertices == b.new_num_vertices


def _assert_streams_equal(a, b):
    assert a.num_rows == b.num_rows and a.slice_edges == b.slice_edges
    for f in STREAM_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.val.view(np.uint32), b.val.view(np.uint32))


# ---------------------------------------------------------------------------
# merge_edge_delta and EdgeDelta
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,grow", [(0, 0), (1, 0), (2, 3), (3, 7)])
def test_merge_bit_identical_to_reference(graph, seed, grow):
    d = rrandom(graph, np.random.default_rng(seed), n_add=25, n_remove=12, grow=grow)
    rg, rinfo = d.apply(graph)
    tg, tinfo = _tdelta(d).apply(_port(graph))
    _assert_graphs_equal(rg, tg)
    for f in INFO_FIELDS:
        np.testing.assert_array_equal(getattr(rinfo, f), getattr(tinfo, f), err_msg=f)


def test_merge_removal_can_empty_a_source_to_dangling():
    g = COOGraph.from_edges(np.array([0, 0, 1]), np.array([1, 2, 2]), 4)
    kw = dict(remove_src=[0, 0], remove_dst=[1, 2])
    rg, _ = REdgeDelta(**kw).apply(g)
    tg, _ = TEdgeDelta(**kw).apply(_port(g))
    assert tg.dangling[0]
    _assert_graphs_equal(rg, tg)


def test_merge_multi_edge_multiplicity():
    g = COOGraph.from_edges(np.array([0, 0, 0, 1]), np.array([1, 1, 2, 0]), 3)
    rg, _ = REdgeDelta(remove_src=[0], remove_dst=[1]).apply(g)
    tg, _ = TEdgeDelta(remove_src=[0], remove_dst=[1]).apply(_port(g))
    assert tg.num_edges == 3                       # one instance removed
    _assert_graphs_equal(rg, tg)


@pytest.mark.parametrize("case", ["shrink", "add_range", "remove_range", "missing",
                                  "over_removal"])
def test_merge_raises_the_reference_errors(graph, case):
    v = graph.num_vertices
    missing = (int(graph.y[0]), (int(graph.x[0]) + 1) % v)
    while np.any((graph.y == missing[0]) & (graph.x == missing[1])):
        missing = (missing[0], (missing[1] + 1) % v)
    args = {"shrink": ([0], [1], [], [], v - 1),
            "add_range": ([v + 5], [0], [], [], None),
            "remove_range": ([], [], [v], [0], None),
            "missing": ([], [], [missing[0]], [missing[1]], None),
            "over_removal": ([], [], [int(graph.y[0])] * 40, [int(graph.x[0])] * 40,
                             None)}[case]
    errors = []
    for merge, g in ((rmerge, graph), (tmerge, _port(graph))):
        with pytest.raises(ValueError) as e:
            merge(g, *args[:4], new_num_vertices=args[4])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="length mismatch"):
        TEdgeDelta(add_src=[1, 2], add_dst=[3])


def test_affected_frontier_matches_reference(graph):
    g = COOGraph.from_edges(np.array([0, 2, 3]), np.array([1, 1, 2]), 5)
    np.testing.assert_array_equal(
        TEdgeDelta(add_src=[1], add_dst=[4]).affected_frontier(_port(g)), [0, 1, 2, 4])
    for seed in range(3):
        d = rlocalized(graph, np.random.default_rng(seed), n_add=2, n_remove=1)
        np.testing.assert_array_equal(d.affected_frontier(graph),
                                      _tdelta(d).affected_frontier(_port(graph)))


@pytest.mark.parametrize("kw", [dict(), dict(grow=4), dict(center=17),
                                dict(n_add=0, n_remove=30)],
                         ids=["global", "grow", "center", "remove_only"])
def test_random_delta_same_from_the_same_seed(graph, kw):
    a = rrandom(graph, np.random.default_rng(11), **kw)
    b = trandom(_port(graph), np.random.default_rng(11), **kw)
    _assert_deltas_equal(a, b)


@pytest.mark.parametrize("n_add,n_remove", [(4, 1), (0, 3)])
def test_localized_delta_same_from_the_same_seed(graph, n_add, n_remove):
    a = rlocalized(graph, np.random.default_rng(5), n_add=n_add, n_remove=n_remove)
    b = tlocalized(_port(graph), np.random.default_rng(5), n_add=n_add, n_remove=n_remove)
    _assert_deltas_equal(a, b)


# ---------------------------------------------------------------------------
# the warm-start store
# ---------------------------------------------------------------------------
def test_warm_start_store_lru_and_grow_like_the_reference():
    stores = (RWarm(capacity_per_graph=2), TWarm(capacity_per_graph=2))
    for ws in stores:
        ws.put("g", 1, "f32", np.ones(4, np.float32))
        ws.put("g", 2, "Q1.25", np.full(4, 7, np.uint32))
        assert ws.get("g", 1, "f32") is not None    # refresh 1 → 2 oldest
        ws.put("g", 3, "f32", np.ones(4, np.float32))
        assert ws.get("g", 2, "Q1.25") is None
        ws.put("g", 2, "Q1.25", np.full(4, 7, np.uint32))
        ws.grow("g", 6)
    (r, t) = stores
    assert r.stats() == t.stats() and t.stats()["evictions"] == 2
    for key in ((3, "f32"), (2, "Q1.25")):
        a, b = r.get("g", *key), t.get("g", *key)
        assert b.shape == (6,) and b.dtype == a.dtype and b[4:].sum() == 0
        np.testing.assert_array_equal(a, b)
    assert t.drop_graph("g") == 2 and len(t) == 0
    with pytest.raises(ValueError):
        TWarm(capacity_per_graph=-1)


# ---------------------------------------------------------------------------
# registered graphs
# ---------------------------------------------------------------------------
def test_registered_graph_incremental_requantization(graph):
    """Only changed values go through the quantizer, yet every prepared
    format (Q1.19–Q1.25) equals quantizing the merged graph, in both
    packages, and the re-uploads equal a fresh registration's."""
    bits = (20, 22, 24, 26)
    d = rrandom(graph, np.random.default_rng(3), n_add=30, n_remove=15, grow=2)
    rrg, trg = RRegistered("g", graph), TRegistered("g", _port(graph), device=CPU)
    for b in bits:
        rrg.quantized(format_for_bits(b))
        trg.quantized(tformat_for_bits(b))
    rrg.apply_delta(d)
    trg.apply_delta(_tdelta(d))
    tget("fixed").on_delta(trg, None)
    assert trg.epoch == 1 and trg.num_vertices == graph.num_vertices + 2
    merged, _ = d.apply(graph)
    fresh = TRegistered("g", _port(merged), device=CPU)
    for b in bits:
        rf, tf = format_for_bits(b), tformat_for_bits(b)
        np.testing.assert_array_equal(trg._quantized_host[tf], merged.quantized_val(rf))
        np.testing.assert_array_equal(trg._quantized_host[tf], rrg._quantized_host[rf])
        assert torch.equal(trg.quantized(tf), fresh.quantized(tf))
    for a, b in zip(trg.device_full(), fresh.device_full()):
        assert torch.equal(a, b)
    assert torch.equal(trg.dangling, fresh.dangling)
    np.testing.assert_array_equal(trg._outdeg, np.bincount(merged.y, minlength=merged.num_vertices))


def _prepared_fused(g, **kw):
    kw.setdefault("packet", 64)
    kw.setdefault("v_tile", 128)
    rg = FusedRegisteredGraph("g", g, device=CPU, **kw)
    tget("fused_float").prepare(rg)
    tget("fused_fixed").prepare(rg, tformat_for_bits(20))
    return rg


def test_fused_refresh_matches_reference_layout_and_fresh_stream():
    g = _prime_graph(seed=7)
    # sources 620 and 625 are dangling: their new edges dirty only their dst
    # blocks; the removal renormalizes the source's other out-edges' blocks
    delta = dict(add_src=[620, 620, 625], add_dst=[640, 11, 2],
                 remove_src=[int(g.y[0])], remove_dst=[int(g.x[0])])
    ref = PallasRegisteredGraph("g", g, packet=64, v_tile=128)
    ref.fused_layout()
    ref.apply_delta(REdgeDelta(**delta))
    ref.refresh_fused()

    rg = _prepared_fused(_port(g))
    old_lay, old_stream = rg.fused_layout(), rg.fused_stream()
    rg.apply_delta(TEdgeDelta(**delta))
    tget("fused_float").on_delta(rg, None)
    stream = rg.fused_stream()
    assert stream is not old_stream
    tget("fused_fixed").on_delta(rg, None)           # the latch: a no-op
    assert rg.fused_stream() is stream and rg.epoch == 1
    # the refreshed layout equals a fresh build of the merged graph, and the
    # reference's refreshed layout but in step_src: the reference gives a
    # clean block's rows the dst block (src/repro/kernels/fused_ppr.py:190)
    lay, rlay = rg.fused_layout(), ref.fused_layout()
    rfresh = PallasRegisteredGraph("g", ref.source, packet=64, v_tile=128).fused_layout()
    for f in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(lay, f), getattr(rfresh, f), err_msg=f)
        if f != "step_src":
            np.testing.assert_array_equal(getattr(lay, f), getattr(rlay, f), err_msg=f)
    assert not np.array_equal(rlay.step_src, rfresh.step_src)
    _, info = REdgeDelta(**delta).apply(g)
    dirty = set((info.changed_dst // 128).tolist())
    assert rg.last_refresh_blocks == len(dirty)
    clean = [d for d in range(lay.n_blk) if d not in dirty]
    assert clean, "the delta must leave a clean block"
    for d in clean:                                   # the same arrays, not copies
        assert lay.row_x[d] is old_lay.row_x[d] and lay.row_val[d] is old_lay.row_val[d]
    fresh = _prepared_fused(rg.source)
    _assert_streams_equal(stream, fresh.fused_stream())
    fmt = tformat_for_bits(20)
    for fm in (None, fmt):
        assert torch.equal(rg.fused_values(fm), fresh.fused_values(fm))
    assert torch.equal(rg.fused_dangling(), fresh.fused_dangling())
    topo, ftopo = rg.fused_topology(), fresh.fused_topology()
    for f in STREAM_FIELDS:
        assert torch.equal(getattr(topo, f), getattr(ftopo, f)), f
    assert (topo.slice_edges, topo.src_rows) == (ftopo.slice_edges, ftopo.src_rows)


def test_fused_growth_across_a_block_forces_full_rebuild():
    g = _prime_graph(v=100, e=300, seed=11)
    rg = _prepared_fused(_port(g), v_tile=64)
    assert rg.fused_layout().n_blk == 2
    rg.apply_delta(TEdgeDelta(add_src=[1], add_dst=[199], new_num_vertices=200))
    tget("fused_fixed").on_delta(rg, None)
    lay = rg.fused_layout()
    assert lay.n_blk == 4 and lay.num_vertices == 200 and rg.last_refresh_blocks is None
    fresh = _prepared_fused(rg.source, v_tile=64)
    np.testing.assert_array_equal(lay.x2, fresh.fused_layout().x2)
    _assert_streams_equal(rg.fused_stream(), fresh.fused_stream())
    assert torch.equal(rg.fused_values(tformat_for_bits(20)),
                       fresh.fused_values(tformat_for_bits(20)))


def test_fused_refresh_releases_the_old_uploads():
    g = _prime_graph(seed=3)
    rg = _prepared_fused(_port(g))
    old = rg.fused_stream()
    uploaded = set(old._device)
    col = weakref.ref(rg.fused_topology().col)
    val = weakref.ref(rg.fused_values(tformat_for_bits(20)))
    rg.apply_delta(TEdgeDelta(add_src=[5], add_dst=[6]))
    tget("fused_fixed").on_delta(rg, None)
    assert not old._device and col() is None and val() is None
    assert set(rg.fused_stream()._device) == uploaded


def test_fused_refresh_recuts_slices_when_the_edge_count_crosses_a_size():
    """256,000 edges take 32-edge slices; 64 more take 64-edge slices."""
    rng = np.random.default_rng(4)
    v = 20_000
    g = COOGraph.from_edges(rng.integers(0, v, 255_990), rng.integers(0, v, 255_990), v)
    rg = FusedRegisteredGraph("g", _port(g), packet=256, v_tile=4096, device=CPU)
    tget("fused_float").prepare(rg)
    assert rg.fused_stream().slice_edges == 32
    d = REdgeDelta(add_src=rng.integers(0, v, 64), add_dst=rng.integers(0, v, 64))
    rg.apply_delta(_tdelta(d))
    tget("fused_float").on_delta(rg, None)
    merged, _ = d.apply(g)
    want = build_dst_stream(build_fused_layout(_port(merged), 4096, 256))
    assert want.slice_edges == 64
    _assert_streams_equal(rg.fused_stream(), want)
    assert rg.fused_topology().slice_edges == 64


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
def _raw(rec, scale):
    raw = np.asarray(rec.scores) * scale
    out = raw.round().astype(np.uint64)
    np.testing.assert_array_equal(raw, out)          # exactly representable
    return out


def _assert_recs_match(r, t, fmt):
    np.testing.assert_array_equal(r.vertices, t.vertices)
    if fmt is None:
        np.testing.assert_allclose(r.scores, t.scores, rtol=0, atol=FLOAT_TOL)
    else:
        np.testing.assert_array_equal(_raw(r, fmt.scale), _raw(t, fmt.scale))


@pytest.mark.parametrize("engine", ["fused", "single"])
def test_service_delta_report_and_rejections_match_reference(graph, engine):
    rng = np.random.default_rng(0)
    d = rlocalized(graph, rng, n_add=2, n_remove=1)
    frontier = sorted(int(v) for v in d.affected_frontier(graph))
    outside = [v for v in range(graph.num_vertices) if v not in set(frontier)]
    cached = frontier[:2] + outside[:4]
    pending = frontier[2:4] + outside[4:6]
    svcs = (RService(kappa=8, iterations=4), TService(kappa=8, iterations=4, device=CPU))
    svcs[0].register_graph("g", graph, formats=[26])
    svcs[1].register_graph("g", _port(graph), formats=[26], engine=engine)
    reports, rejected, keys = [], [], []
    for svc, q_cls, delta in ((svcs[0], RQuery, d), (svcs[1], TQuery, _tdelta(d))):
        futs = [svc.submit(q_cls("g", v, k=5, precision=26)) for v in cached]
        svc.flush()
        for f in futs:
            f.result()
        futs = [svc.submit(q_cls("g", v, k=5, precision=26)) for v in pending]
        k0 = svc._cache_key(q_cls("g", 1, k=5), "Q1.25")
        report = svc.apply_delta("g", delta)
        report.pop("apply_s")
        reports.append(report)
        keys.append((k0, svc._cache_key(q_cls("g", 1, k=5), "Q1.25")))
        out = set()
        for f in futs:
            if f.done():
                with pytest.raises(Exception) as e:
                    f.result()
                assert e.value.code == "delta-invalidated"
                if svc is svcs[1]:
                    assert isinstance(e.value, QueryRejected)
                out.add(f.query.vertex)
        rejected.append(out)
    assert reports[0] == reports[1]
    assert reports[1]["pending_dropped"] == 2 and reports[1]["cache_dropped"] == 2
    assert rejected[0] == rejected[1] == set(frontier[2:4])
    assert keys[0] == keys[1] and keys[1][0] != keys[1][1]
    assert keys[1][0][1] == 0 and keys[1][1][1] == 1
    tsvc = svcs[1]
    assert tsvc.telemetry_summary()["deltas_applied"] == 1
    assert tsvc.recorder.events_of_kind("delta")[0]["epoch"] == 1
    survivors = [tsvc.submit(TQuery("g", v, k=5, precision=26)) for v in outside[:4]]
    assert all(f.result().source == "cache" for f in survivors)   # retagged
    assert tsvc.flush() == 1                         # the requeued survivors


@pytest.mark.parametrize("engine,grow", [("fused", 0), ("fused", 3), ("single", 3)])
def test_service_post_delta_answers_match_reference(graph, engine, grow):
    d = rrandom(graph, np.random.default_rng(7), n_add=18, n_remove=9, grow=grow)
    rfmt = format_for_bits(26)
    rsvc = RService(kappa=4, iterations=8)
    rsvc.register_graph("g", graph, formats=[26])
    tsvc = TService(kappa=4, iterations=8, device=CPU)
    tsvc.register_graph("g", _port(graph), formats=[26], engine=engine)
    probe = [1, 5, 9, graph.num_vertices - 1] + ([graph.num_vertices + grow - 1]
                                                 if grow else [])
    rsvc.serve([RQuery("g", v, k=10, precision=26) for v in probe[:4]])
    tsvc.run_batch([TQuery("g", v, k=10, precision=26) for v in probe[:4]])
    rsvc.apply_delta("g", d)
    tsvc.apply_delta("g", _tdelta(d))
    for prec, fmt in ((26, rfmt), (None, None)):
        r = rsvc.serve([RQuery("g", v, k=10, precision=prec) for v in probe])
        t = tsvc.run_batch([TQuery("g", v, k=10, precision=prec) for v in probe])
        for a, b in zip(r, t):
            assert a.source == b.source == "wave"
            _assert_recs_match(a, b, fmt)


def test_service_delta_that_removes_every_edge(graph):
    """An empty stream after the delta: every vertex dangling, both families
    and the reference agree."""
    g = COOGraph.from_edges(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]), 5)
    d = REdgeDelta(remove_src=[0, 1, 2, 2], remove_dst=[1, 2, 0, 3])
    rsvc = RService(kappa=2, iterations=5)
    rsvc.register_graph("g", g, formats=[26])
    rsvc.apply_delta("g", d)
    for engine in ("fused", "single"):
        tsvc = TService(kappa=2, iterations=5, device=CPU)
        tsvc.register_graph("g", _port(g), formats=[26], engine=engine)
        tsvc.apply_delta("g", _tdelta(d))
        if engine == "fused":
            assert tsvc.registered_graph("g").fused_stream().num_edges == 0
        for prec, fmt in ((26, format_for_bits(26)), (None, None)):
            r = rsvc.serve([RQuery("g", v, k=3, precision=prec) for v in (0, 4)])
            t = tsvc.run_batch([TQuery("g", v, k=3, precision=prec) for v in (0, 4)])
            for a, b in zip(r, t):
                _assert_recs_match(a, b, fmt)


@pytest.mark.parametrize("engine,bits", [("fused", 26), ("fused", 20), ("single", 26)])
def test_warm_start_matches_reference_bit_for_bit(graph, engine, bits):
    """Cold wave, delta, warm wave: the same iteration counts, the same
    iterations saved and the same raw states (the stored columns) as the
    reference, from the same seed columns."""
    verts = [3, 9, 40, 77]
    d = REdgeDelta(add_src=[3, 9], add_dst=[50, 60])
    rsvc = RService(kappa=4, iterations=60, early_exit=True, warm_start=True)
    rsvc.register_graph("g", graph, formats=[bits])
    tsvc = TService(kappa=4, iterations=60, early_exit=True, warm_start=True, device=CPU)
    tsvc.register_graph("g", _port(graph), formats=[bits], engine=engine)
    summaries = []
    for step in ("cold", "delta", "warm"):
        if step == "delta":
            rsvc.apply_delta("g", d)
            tsvc.apply_delta("g", _tdelta(d))
            continue
        r = rsvc.serve([RQuery("g", v, k=5, precision=bits) for v in verts])
        t = tsvc.run_batch([TQuery("g", v, k=5, precision=bits) for v in verts])
        for a, b in zip(r, t):
            assert a.source == b.source
            _assert_recs_match(a, b, format_for_bits(bits))
        rs, ts = rsvc.telemetry_summary(), tsvc.telemetry_summary()
        for key in ("iterations_saved", "early_exit_waves", "warm_start_waves",
                    "warm_start_columns", "warm_start_iterations_saved",
                    "warm_size", "warm_hits", "warm_misses"):
            assert rs[key] == ts[key], key
        summaries.append(ts)
    assert tsvc._cold_iters == rsvc._cold_iters
    assert summaries[1]["warm_start_waves"] == 1
    assert summaries[1]["warm_start_iterations_saved"] > 0
    pkey = format_for_bits(bits).name
    for v in verts:
        a, b = rsvc._warm.get("g", v, pkey), tsvc._warm.get("g", v, pkey)
        assert b.dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(a), b)


def test_warm_cache_key_and_reregistration(graph):
    q = ("g", 0)
    cold, warm = TService(kappa=1, iterations=4, device=CPU), \
        TService(kappa=1, iterations=4, warm_start=8, device=CPU)
    assert cold._cache_key(TQuery(*q, k=5), "f32") != warm._cache_key(TQuery(*q, k=5), "f32")
    for svc, ref in ((cold, RService(kappa=1, iterations=4)),
                     (warm, RService(kappa=1, iterations=4, warm_start=8))):
        assert svc._cache_key(TQuery(*q, k=5), "f32") == ref._cache_key(RQuery(*q, k=5), "f32")
    assert warm._warm.capacity_per_graph == 8 and cold._warm is None
    warm.register_graph("g", _port(graph))
    warm.run_batch([TQuery("g", 3, k=5)])
    assert len(warm._warm) == 1
    warm.register_graph("g", _port(graph))           # re-registration drops them
    assert len(warm._warm) == 0


def test_warm_seed_ignores_a_column_of_another_vertex_count(graph):
    """A wave planned before a growth delta keeps its plan's vertex count; a
    column grown since (or stored before) is not used as its seed."""
    svc = TService(kappa=2, iterations=4, warm_start=True, device=CPU)
    svc.register_graph("g", _port(graph))
    svc.run_batch([TQuery("g", 3, k=5)])
    v = graph.num_vertices
    fut = svc.submit(TQuery("g", 3, k=5))            # a cache hit: a stand-in item
    w = Wave(key=("g", "f32", "single", 0), items=[fut], enqueued_at=[0.0], full=False)
    P0, n = svc._warm_seed(svc.registered_graph("g"), w, "f32", torch.zeros((v, 2)))
    assert n == 1 and torch.equal(P0[:, 1], P0[:, 0])   # the pad mirrors column 0
    assert torch.equal(P0[:, 0], torch.from_numpy(svc._warm.get("g", 3, "f32")))
    P0, n = svc._warm_seed(svc.registered_graph("g"), w, "f32", torch.zeros((v + 3, 2)))
    assert n == 0
