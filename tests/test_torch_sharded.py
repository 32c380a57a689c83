"""Port parity, mesh-sharded serving: ``repro_torch``'s dst-range shards
against ``repro``'s.

The reference's sharded SpMV raises ``ShardingTypeError`` on this JAX for
S > 1 (its own ``tests/test_sharded_serving.py`` fails there), so the port
is held to (a) the reference's single-device functions and engines at every
S — fixed point raw-bit equal, float within 1e-6 — (b) the reference's
sharded functions on a one-device mesh at S = 1, and (c) the reference's
host partitioning at every S, array-equal, including its
``ShardedRegisteredGraph`` built on a stand-in mesh (it reads only
``shape`` and ``axis_names``) before and after a delta.  Every mesh of the
port here is on the CPU, where each shard's ``coo_spmv_kernel`` runs its
plain version.  Fixtures: the V = 641 graph of the other port tests (tail
vertices dangling), V = 640 (divisible by every S but 3) and V = 7 (S = 8
leaves the last shard one phantom row and no edge).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import autotune as rauto  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.core import ppr as rppr  # noqa: E402
from repro.core import spmv as rspmv  # noqa: E402
from repro.core.coo import COOGraph  # noqa: E402
from repro.core.fixed_point import format_for_bits  # noqa: E402
from repro.graph_updates import random_delta as rrandom  # noqa: E402
from repro.graphs import erdos_renyi  # noqa: E402
from repro.ppr_serving import PPRQuery as RQuery  # noqa: E402
from repro.ppr_serving import PPRService as RService  # noqa: E402
from repro.ppr_serving.engine import sharded as rsharded  # noqa: E402
from repro.ppr_serving.graphs import ShardedRegisteredGraph as RSharded  # noqa: E402
from repro_torch import autotune as tauto  # noqa: E402
from repro_torch.convert import graph_from_arrays, raw_to_numpy, raw_to_torch  # noqa: E402
from repro_torch.core import ppr as tppr  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.fixed_point import format_for_bits as tformat_for_bits  # noqa: E402
from repro_torch.graph_updates import EdgeDelta as TEdgeDelta  # noqa: E402
from repro_torch.kernels.dst_stream import build_dst_stream  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.ppr_serving import PPRQuery as TQuery  # noqa: E402
from repro_torch.ppr_serving import PPRService as TService  # noqa: E402
from repro_torch.ppr_serving import ShardedRegisteredGraph as TSharded  # noqa: E402
from repro_torch.ppr_serving.engine import sharded as tsharded  # noqa: E402

ALPHA = 0.85
CPU = "cpu"
FMT, TFMT = format_for_bits(26), tformat_for_bits(26)
SHARDS = (1, 2, 3, 4, 8)
SIZES = (641, 640, 7)
CASES = [(v, s) for v in SIZES for s in SHARDS]
CASE_IDS = [f"V{v}-S{s}" for v, s in CASES]


def _graph(v=641, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    if v < 50:
        return COOGraph.from_edges(rng.integers(0, v - 1, 3 * v), rng.integers(0, v, 3 * v), v)
    # sources capped below v-40 ⇒ the tail vertices are dangling
    return COOGraph.from_edges(rng.integers(0, v - 40, e), rng.integers(0, v, e), v)


def _port(g):
    return graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices)


def _stub_mesh(s):
    return types.SimpleNamespace(shape={"shard": s}, axis_names=("shard",))


def _cpu_mesh(s):
    return make_mesh((s,), ("shard",), device=CPU)


def _shard_operands(g, s, fmt=None):
    """Each shard's (topology, values) on the CPU, from the port's buckets."""
    x, y, val = (a.reshape(s, -1) for a in tspmv.partition_edges_by_dst(
        g.x, g.y, g.val, g.num_vertices, s))
    v_local, _ = tspmv.sharded_vertex_layout(g.num_vertices, s)
    streams = [build_dst_stream((x[i], y[i], val[i], v_local)) for i in range(s)]
    return [(st.topology(CPU), st.values(CPU, fmt)) for st in streams]


def _p(v, k=4, seed=1):
    return (np.random.default_rng(seed).random((v, k)) / v).astype(np.float32)


# ---------------------------------------------------------------------------
# host layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,s", CASES, ids=CASE_IDS)
def test_layout_and_partition_array_equal_reference(v, s):
    """``sharded_vertex_layout`` and ``partition_edges_by_dst`` on float32
    and raw uint32 values: the same arrays, the same dtypes."""
    g = _graph(v)
    assert tspmv.sharded_vertex_layout(v, s) == rspmv.sharded_vertex_layout(v, s)
    for val in (g.val, g.quantized_val(FMT)):
        want = rspmv.partition_edges_by_dst(g.x, g.y, val, v, s, packet=64)
        got = tspmv.partition_edges_by_dst(g.x, g.y, val, v, s, packet=64)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[2].dtype == np.uint32


@pytest.mark.parametrize("s", (3, 8))
def test_shard_streams_hold_the_bucket_edges(s):
    """Each shard's stream is its bucket without the pad slots, sorted
    stably by local dst, over ``v_local`` rows; its raw Q1.25 values are the
    quantized bucket's bits in stream order."""
    g = _graph()
    v_local, _ = tspmv.sharded_vertex_layout(g.num_vertices, s)
    x, y, val = (a.reshape(s, -1) for a in tspmv.partition_edges_by_dst(
        g.x, g.y, g.val, g.num_vertices, s))
    _, _, raw = tspmv.partition_edges_by_dst(g.x, g.y, g.quantized_val(FMT),
                                             g.num_vertices, s)
    raw = raw.reshape(s, -1)
    for i in range(s):
        st = build_dst_stream((x[i], y[i], val[i], v_local))
        real = val[i] != 0
        order = np.argsort(x[i][real], kind="stable")
        assert st.num_rows == v_local
        np.testing.assert_array_equal(np.repeat(np.arange(v_local), np.diff(st.row_ptr)),
                                      x[i][real][order])
        np.testing.assert_array_equal(st.col, y[i][real][order])
        np.testing.assert_array_equal(st.val, val[i][real][order])
        np.testing.assert_array_equal(st.raw_values(TFMT).view(np.uint32),
                                      raw[i][real][order])


# ---------------------------------------------------------------------------
# the sharded SpMV and steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,s", CASES, ids=CASE_IDS)
def test_sharded_spmv_equals_reference_single_device(v, s):
    """Fixed point raw-bit equal to ``spmv_fixed``, float within 1e-6 of
    ``spmv_float``, at every V and S (the gather cuts the phantom rows)."""
    g, mesh, p = _graph(v), _cpu_mesh(s), _p(v)
    want = rspmv.spmv_float(jnp.asarray(g.x), jnp.asarray(g.y), jnp.asarray(g.val),
                            jnp.asarray(p), v)
    got = tspmv.make_sharded_spmv(mesh, "shard", v)(_shard_operands(g, s),
                                                     torch.as_tensor(p))
    assert tuple(got.shape) == (v, 4)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    praw = np.asarray(FMT.from_float(jnp.asarray(p)))
    want = rspmv.spmv_fixed(jnp.asarray(g.x), jnp.asarray(g.y),
                            jnp.asarray(g.quantized_val(FMT)), jnp.asarray(praw), v, FMT)
    got = tspmv.make_sharded_spmv_fixed(mesh, "shard", v, TFMT)(
        _shard_operands(g, s, TFMT), raw_to_torch(praw))
    np.testing.assert_array_equal(raw_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("v", (641, 7))
def test_sharded_spmv_equals_reference_sharded_at_one_shard(v):
    """The reference's own ``make_sharded_spmv[_fixed]`` on a one-device
    ``jax.make_mesh((1,), ("shard",))``: the same rows."""
    g, p = _graph(v), _p(v)
    rmesh = jax.make_mesh((1,), ("shard",))
    x, y, val = rspmv.partition_edges_by_dst(g.x, g.y, g.val, v, 1)
    _, _, raw = rspmv.partition_edges_by_dst(g.x, g.y, g.quantized_val(FMT), v, 1)
    praw = FMT.from_float(jnp.asarray(p))
    with set_mesh(rmesh):
        want_f = rspmv.make_sharded_spmv(rmesh, "shard", v)(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(val), jnp.asarray(p))
        want_q = rspmv.make_sharded_spmv_fixed(rmesh, "shard", v, FMT)(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(raw), praw)
    mesh = _cpu_mesh(1)
    got_f = tspmv.make_sharded_spmv(mesh, "shard", v)(_shard_operands(g, 1),
                                                       torch.as_tensor(p))
    got_q = tspmv.make_sharded_spmv_fixed(mesh, "shard", v, TFMT)(
        _shard_operands(g, 1, TFMT), raw_to_torch(np.asarray(praw)))
    assert np.abs(got_f.numpy() - np.asarray(want_f)).max() < 1e-6
    np.testing.assert_array_equal(raw_to_numpy(got_q), np.asarray(want_q))


@pytest.mark.parametrize("s", (1, 3, 8))
@pytest.mark.parametrize("domain", ("fixed", "float"))
def test_ten_sharded_steps_equal_reference_steps(domain, s):
    """Ten chained sharded steps against the reference's
    ``make_ppr_fixed_step`` (raw bits) and ``ppr_step_float`` (1e-6)."""
    g = _graph()
    v = g.num_vertices
    mesh = _cpu_mesh(s)
    pers = np.asarray([0, 17, 388, 640], np.int32)
    dang = jnp.asarray(g.dangling)
    tdang = torch.as_tensor(g.dangling)
    if domain == "fixed":
        fmt, tfmt = format_for_bits(24), tformat_for_bits(24)
        ref_step = rppr.make_ppr_fixed_step(fmt, v, ALPHA)
        step = tppr.make_ppr_sharded_fixed_step(tfmt, mesh, "shard", v, ALPHA)
        Vr = rppr.personalization_matrix_fixed(v, jnp.asarray(pers), fmt)
        Vt = tppr.personalization_matrix_fixed(v, torch.as_tensor(pers), tfmt)
        args = (jnp.asarray(g.x), jnp.asarray(g.y), jnp.asarray(g.quantized_val(fmt)))
        shards = _shard_operands(g, s, tfmt)
    else:
        ref_step = lambda x, y, val, d, Vm, P: rppr.ppr_step_float(  # noqa: E731
            x, y, val, d, Vm, P, num_vertices=v, alpha=ALPHA)
        step = tppr.make_ppr_sharded_float_step(mesh, "shard", v, ALPHA)
        Vr = rppr.personalization_matrix(v, jnp.asarray(pers))
        Vt = tppr.personalization_matrix(v, torch.as_tensor(pers))
        args = (jnp.asarray(g.x), jnp.asarray(g.y), jnp.asarray(g.val))
        shards = _shard_operands(g, s)
    Pr, Pt = Vr, Vt
    for _ in range(10):
        Pr = ref_step(*args, dang, Vr, Pr)
        Pt = step(shards, tdang, Vt, Pt)
    if domain == "fixed":
        np.testing.assert_array_equal(raw_to_numpy(Pt), np.asarray(Pr))
    else:
        assert np.abs(Pt.numpy() - np.asarray(Pr)).max() < 1e-6


# ---------------------------------------------------------------------------
# the registered graph and its delta refresh
# ---------------------------------------------------------------------------
def _assert_buckets_equal(t, r):
    for name in ("_host_x", "_host_y", "_host_val"):
        a, b = getattr(t, name), getattr(r, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(t._sharded_quant_host) == {TFMT} and set(r._sharded_quant_host) == {FMT}
    a, b = t._sharded_quant_host[TFMT], r._sharded_quant_host[FMT]
    assert a.dtype == b.dtype == np.uint32
    np.testing.assert_array_equal(a, b)


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("row_ptr", "col", "val", "nz_rows", "slice_row"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)
        assert (x.num_rows, x.slice_edges) == (y.num_rows, y.slice_edges)


@pytest.mark.parametrize("s", (3, 4))
@pytest.mark.parametrize("grow", (0, 40), ids=("per-bucket", "re-partition"))
def test_host_buckets_equal_reference_before_and_after_a_delta(grow, s):
    """The port's ``ShardedRegisteredGraph`` against the reference's on a
    stand-in mesh: equal host buckets at registration and after ``apply_delta``
    + ``refresh_partition_after_delta`` (a growth of 40 vertices moves
    ``ceil(V / S)`` and re-partitions); the refreshed streams equal a fresh
    registration's, and the per-bucket path rebuilds only the affected
    shards' streams."""
    g = _graph()
    r = RSharded("g", g, _stub_mesh(s))
    rsharded.partition_format(r, FMT)
    t = TSharded("g", _port(g), _cpu_mesh(s), device=CPU)
    tsharded.partition_format(t, TFMT)
    _assert_buckets_equal(t, r)
    d = rrandom(g, np.random.default_rng(s), n_add=12, n_remove=5, grow=grow)
    rinfo = r.apply_delta(d)
    rsharded.refresh_partition_after_delta(r, rinfo)
    before = list(t.shard_streams)
    tinfo = t.apply_delta(TEdgeDelta(add_src=d.add_src, add_dst=d.add_dst,
                                     remove_src=d.remove_src, remove_dst=d.remove_dst,
                                     new_num_vertices=d.new_num_vertices))
    for _ in range(2):                          # both members armed: one refresh
        tsharded.refresh_partition_after_delta(t, tinfo)
    _assert_buckets_equal(t, r)
    merged, _ = d.apply(g)
    fresh = TSharded("g", _port(merged), _cpu_mesh(s), device=CPU)
    _assert_streams_equal(t.shard_streams, fresh.shard_streams)
    if grow:
        assert t.last_refresh_shards is None
    else:
        touched = set(t.last_refresh_shards)
        assert touched and touched == set(np.unique(tinfo.changed_dst // -(-641 // s)))
        for i, st in enumerate(t.shard_streams):
            assert (st is before[i]) == (i not in touched)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
def _recs_equal(got, want, float_tol=1e-6):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        assert a.precision == b.precision and a.source == b.source
        if a.precision == "f32":
            assert np.abs(a.scores - b.scores).max(initial=0.0) <= float_tol
        else:
            np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("s", (2, 4, 8))
def test_meshed_service_equals_reference_single_device(s):
    """Top-K (ties and self-exclusion included) and raw-derived scores
    identical to the reference's single-device service on Q1.25 and Q1.19
    traffic, float within 1e-6, and the wave counts under the mesh's key."""
    g = _graph()
    verts = np.random.default_rng(0).integers(0, g.num_vertices, 8)
    r = RService(kappa=8, iterations=10)
    r.register_graph("g", g, formats=[26])
    t = TService(kappa=8, iterations=10, device=CPU)
    rg = t.register_graph("g", _port(g), formats=[26], mesh=_cpu_mesh(s))
    assert isinstance(rg, TSharded) and rg.mesh_key == f"mesh:shardx{s}"
    for prec in (26, 20, None):
        want = r.run_batch([RQuery("g", int(v), k=10, precision=prec) for v in verts])
        got = t.run_batch([TQuery("g", int(v), k=10, precision=prec) for v in verts])
        _recs_equal(got, want)
    ts, rs = t.telemetry_summary(), r.telemetry_summary()
    assert ts[f"waves_mesh:shardx{s}"] == rs["waves_single"] == 3
    assert ts[f"queries_mesh:shardx{s}"] == rs["queries_single"] == 24
    again = t.run_batch([TQuery("g", int(verts[0]), k=10, precision=26)])
    assert again[0].source == "cache"


def test_meshed_service_early_exit_iterations_equal_reference():
    """Early exit on the mesh: the same iteration counts and answers as the
    reference's single-device service (fixed, budget 120)."""
    g = _graph()
    verts = [0, 5, 300, 640]
    r = RService(kappa=4, iterations=120, early_exit=True, cache_capacity=0)
    r.register_graph("g", g, formats=[20])
    t = TService(kappa=4, iterations=120, early_exit=True, cache_capacity=0, device=CPU)
    t.register_graph("g", _port(g), formats=[20], mesh=_cpu_mesh(3))
    want = r.run_batch([RQuery("g", v, k=10, precision=20) for v in verts])
    got = t.run_batch([TQuery("g", v, k=10, precision=20) for v in verts])
    _recs_equal(got, want)
    ts, rs = t.telemetry_summary(), r.telemetry_summary()
    keys = [k for k in rs if k.startswith(("early_exit", "iterations_"))]
    assert keys and {k: ts[k] for k in keys} == {k: rs[k] for k in keys}
    assert ts["iterations_saved"] > 0


def test_meshed_registration_rules_and_purge():
    """The reference's rules: "sharded" is the default with a mesh and needs
    one; "fused" and "single" refuse one; a mesh of another device type and
    an unknown axis raise; re-registering drops the meshed graph's pending
    queries; registration prepares the formats' shard values."""
    g = _port(_graph())
    mesh = _cpu_mesh(4)
    t = TService(kappa=8, iterations=5, device=CPU)
    with pytest.raises(ValueError, match="needs a mesh"):
        t.register_graph("g", g, engine="sharded")
    for family in ("fused", "single"):
        with pytest.raises(ValueError, match="single-device"):
            t.register_graph("g", g, mesh=mesh, engine=family)
    with pytest.raises(ValueError, match="cuda"):
        t.register_graph("g", g, mesh=make_mesh((2,), ("shard",), devices=["cuda:0"] * 2))
    with pytest.raises(ValueError, match="no axis"):
        t.register_graph("g", g, mesh=mesh, mesh_axis="model")
    rg = t.register_graph("g", g, formats=[26], mesh=mesh)
    assert TFMT in rg._sharded_quant_host
    assert all(("values", CPU, TFMT) in st._device for st in rg.shard_streams)
    assert not t.submit(TQuery("g", 3, k=5, precision=26)).done()
    assert t.scheduler.pending() == 1
    t.register_graph("g", g, formats=[26], mesh=mesh)
    assert t.scheduler.pending() == 0


@pytest.mark.parametrize("grow", (0, 5), ids=("per-bucket", "re-partition"))
def test_meshed_delta_answers_equal_fresh_and_single(grow):
    """After a delta on a 4-shard mesh (V = 203): Q1.25 answers equal a fresh
    meshed registration's and the reference's single-device service's; float
    answers equal the fresh registration's (tests/test_graph_updates.py:528)."""
    g = _graph(203, 1500, seed=2)
    d = rrandom(g, np.random.default_rng(1), n_add=15, n_remove=6, grow=grow)
    td = TEdgeDelta(add_src=d.add_src, add_dst=d.add_dst, remove_src=d.remove_src,
                    remove_dst=d.remove_dst, new_num_vertices=d.new_num_vertices)
    mesh = _cpu_mesh(4)
    svc = TService(kappa=4, iterations=8, cache_capacity=0, device=CPU)
    svc.register_graph("g", _port(g), formats=[26], mesh=mesh)
    svc.run_batch([TQuery("g", 9, k=8, precision=26), TQuery("g", 9, k=8)])
    svc.apply_delta("g", td)
    merged, _ = d.apply(g)
    fresh = TService(kappa=4, iterations=8, cache_capacity=0, device=CPU)
    fresh.register_graph("g", _port(merged), formats=[26], mesh=mesh)
    single = RService(kappa=4, iterations=8, cache_capacity=0)
    single.register_graph("g", merged, formats=[26])
    probe = [0, 9, 150, 202] + ([202 + grow] if grow else [])
    for prec in (26, None):
        a, b = (s.run_batch([TQuery("g", v, k=8, precision=prec) for v in probe])
                for s in (svc, fresh))
        _recs_equal(a, b, float_tol=0.0)
        if prec is not None:
            _recs_equal(a, single.run_batch([RQuery("g", v, k=8, precision=prec)
                                             for v in probe]))


def test_meshed_auto_precision_rungs_equal_reference(monkeypatch):
    """``precision="auto"`` on a mesh, mixed with explicit and float traffic
    (tests/test_torch_autotune.py's ladder walk): the same resolved
    precisions, promotions, demotions, answers and shadow scores as the
    reference's single-device service; the shadow's float reference runs
    through the sharded float engine, on the mesh."""
    g = erdos_renyi(300, 1800, seed=3)

    def cfg(pkg):
        return pkg.AutotuneConfig(
            ladder=(8, 10, 12), promote_patience=2, demote_patience=2,
            shadow=pkg.ShadowConfig(sample_fraction=0.5, min_samples=2, window=4, seed=3))

    r = RService(kappa=4, iterations=10, autotune=cfg(rauto))
    r.register_graph("g", g, formats=[12])
    t = TService(kappa=4, iterations=10, autotune=cfg(tauto), device=CPU)
    t.register_graph("g", _port(g), formats=[12], mesh=_cpu_mesh(3))
    shadows = []
    real_reference = TService._float_reference
    monkeypatch.setattr(TService, "_float_reference",
                        lambda self, rg, eng, pers: shadows.append((eng.key, rg.mesh_key))
                        or real_reference(self, rg, eng, pers))
    rng = np.random.default_rng(1)
    for _ in range(5):
        batch = [(int(v), "auto" if i % 3 else (None if i % 2 else 12))
                 for i, v in enumerate(rng.integers(0, g.num_vertices, 8))]
        want = r.run_batch([RQuery("g", v, precision=p, quality_target=0.99)
                            for v, p in batch])
        got = t.run_batch([TQuery("g", v, precision=p, quality_target=0.99)
                           for v, p in batch])
        _recs_equal(got, want)
    assert t.telemetry.auto_resolved == r.telemetry.auto_resolved
    assert t.controller.promotions == r.controller.promotions > 0
    assert t.controller.demotions == r.controller.demotions > 0
    a, b = r.telemetry.shadow_scores, t.telemetry.shadow_scores
    assert len(a) == len(b) > 0
    assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-6
    assert shadows and set(shadows) == {("sharded_float", "mesh:shardx3")}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_make_mesh_places_shards_and_reports_them():
    m = make_mesh((4,), ("shard",), device=CPU)
    assert m.shape == {"shard": 4} and m.axis_names == ("shard",)
    assert m.controller == torch.device("cpu") and m.placement == "cpu×4"
    m2 = Mesh([["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]], ("data", "shard"))
    assert m2.shape == {"data": 2, "shard": 2}
    assert m2.axis_devices("shard") == [torch.device("cuda:0"), torch.device("cuda:1")]
    assert m2.axis_devices("data") == [torch.device("cuda:0"), torch.device("cuda:2")]
    assert make_mesh((3,), ("shard",), devices=["cuda:0"] * 3).placement == "cuda:0×3"
    with pytest.raises(ValueError):
        make_mesh((3,), ("shard",), devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        Mesh(["cpu", "cuda:0"], ("shard",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh((2,), ("shard",))
