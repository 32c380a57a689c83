"""Port parity, kernels: each kernel's plain PyTorch version against the JAX
reference's Pallas kernel (run in interpret mode, as the reference's own tests
run it on the CPU), on the reference tests' small fixtures.

On a CPU tensor a kernel wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  The kernels themselves are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")

import jax.numpy as jnp  # noqa: E402

from repro.core import coo as rcoo  # noqa: E402
from repro.core import fixed_point as rfp  # noqa: E402
from repro.core import ppr as rppr  # noqa: E402
from repro.graphs import erdos_renyi  # noqa: E402
from repro.kernels import fused_ppr as rfused  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.convert import graph_from_arrays, raw_to_numpy, raw_to_torch  # noqa: E402
from repro_torch.core import coo as tcoo  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402
from repro_torch.kernels import fused_ppr as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.coo_spmv import coo_spmv_kernel, launch_geometry  # noqa: E402
from repro_torch.kernels.dst_stream import StreamTopology, build_dst_stream  # noqa: E402

ALPHA = 0.85
V_PRIME = 641


def _tfmt(fmt):
    return tfp.QFormat(fmt.int_bits, fmt.frac_bits)


def _port(g):
    return graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices)


def _prime_graph(v=V_PRIME, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    # sources capped below v-40 ⇒ the tail vertices are dangling
    return rcoo.COOGraph.from_edges(rng.integers(0, v - 40, e),
                                    rng.integers(0, v, e), v)


# ---------------------------------------------------------------------------
# kernel 1: coo_spmv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,e,k,v_tile,packet", [
    (256, 1024, 4, 64, 32),
    (500, 3000, 8, 128, 64),
    (100, 400, 1, 128, 128),      # K=1: plain SpMV
    (64, 64, 2, 64, 32),          # single tile
])
def test_coo_spmv_float_matches_pallas(v, e, k, v_tile, packet):
    g = erdos_renyi(v, e, seed=v + e)
    p = (np.random.default_rng(0).random((v, k)) / v).astype(np.float32)
    rb = rcoo.BlockedCOO.build(g, v_tile=v_tile, packet=packet)
    tb = tcoo.BlockedCOO.build(_port(g), v_tile=v_tile, packet=packet)
    out_r = np.asarray(rops.coo_spmv(rb, rops.pad_p_for_blocks(jnp.asarray(p), rb),
                                     interpret=True))
    out_t = tops.coo_spmv(tb, tops.pad_p_for_blocks(torch.from_numpy(p), tb))
    np.testing.assert_allclose(out_t.numpy(), out_r, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("fmt", [rfp.Q1_25, rfp.Q1_19], ids=lambda f: f.name)
def test_coo_spmv_fixed_raw_equal_to_pallas(fmt):
    v, k = 400, 8
    g = erdos_renyi(v, 2500, seed=3)
    p_raw = np.random.default_rng(1).integers(0, fmt.scale // v + 2, (v, k)).astype(np.uint32)
    rb = rcoo.BlockedCOO.build(g, v_tile=128, packet=64)
    tb = tcoo.BlockedCOO.build(_port(g), v_tile=128, packet=64)
    out_r = np.asarray(rops.coo_spmv(rb, rops.pad_p_for_blocks(jnp.asarray(p_raw), rb),
                                     fmt=fmt, interpret=True))
    out_t = tops.coo_spmv(tb, tops.pad_p_for_blocks(raw_to_torch(p_raw), tb),
                          fmt=_tfmt(fmt))
    assert np.array_equal(raw_to_numpy(out_t), out_r)


def test_spmv_operands_stream_uint16_indices_and_dst_ranges():
    """The SpMV's device operands are the BlockedCOO's real edges as CSR over
    its n_dst·v_tile dst rows: global int32 indices, no pad slot."""
    g = _port(erdos_renyi(300, 2000, seed=7))
    b = tcoo.BlockedCOO.build(g, v_tile=64, packet=32)
    topo, val = tops.spmv_operands(b, torch.device("cpu"), tfp.Q1_21)
    assert topo.col.dtype == topo.row_ptr.dtype == torch.int32
    assert topo.slice_edges == tops.dst_stream(b).slice_edges
    assert topo.src_rows == int(g.y.max()) + 1 <= b.n_src * b.v_tile
    row_ptr = topo.row_ptr.numpy()
    assert row_ptr.shape == (b.n_dst * b.v_tile + 1,) and row_ptr[0] == 0
    assert row_ptr[-1] == g.num_edges == topo.num_edges == val.shape[0]
    for d in range(b.n_dst):          # each dst row holds exactly its edges
        for i in range(d * b.v_tile, min((d + 1) * b.v_tile, g.num_vertices), 17):
            mine = g.x == i
            got = topo.col.numpy()[row_ptr[i]:row_ptr[i + 1]]
            assert np.array_equal(np.sort(got), np.sort(g.y[mine]))
    assert np.array_equal(np.sort(raw_to_numpy(val)),
                          np.sort(tcoo.quantize_values(g.val, tfp.Q1_21)))
    assert tops.spmv_operands(b, torch.device("cpu"), tfp.Q1_21)[0] is topo


def _meta_stream(rows=64, edges=64, slice_edges=32, src_rows=64):
    meta = torch.device("meta")
    topo = StreamTopology(
        row_ptr=torch.empty(rows + 1, dtype=torch.int32, device=meta),
        col=torch.empty(edges, dtype=torch.int32, device=meta),
        nz_rows=torch.empty(rows, dtype=torch.int32, device=meta),
        slice_row=torch.empty(-(-edges // slice_edges) + 1, dtype=torch.int32, device=meta),
        slice_edges=slice_edges, src_rows=src_rows)
    return topo, torch.empty(edges, dtype=torch.float32, device=meta)


def test_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda():
    topo, val = _meta_stream()
    p = torch.empty((64, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        coo_spmv_kernel(topo, val, p)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_ppr_iteration(topo, val, topo.slice_row, p, p, alpha=ALPHA)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.dangling_mass(p, topo.slice_row, fixed=False)


def test_stream_wrappers_hold_p_to_the_stream_they_are_given():
    """The wrappers take a stream only as a ``StreamTopology``, whose slice
    schedule comes with the slice size it was cut at, and refuse a P that
    lacks a src row the stream reads, or whose rows are not the stream's
    (fused), before anything is launched."""
    st = build_dst_stream(_stream_sources(_hub_graph())["fused"], slice_edges=64)
    topo = st.topology("cpu")
    assert (topo.slice_edges, topo.num_slices, topo.num_rows) == (
        64, st.num_slices, st.num_rows)
    assert topo.src_rows == int(st.col.max()) + 1
    topo, val = _meta_stream(src_rows=80)
    with pytest.raises(ValueError, match="src rows"):
        coo_spmv_kernel(topo, val, torch.empty((64, 4), device="meta"))
    with pytest.raises(ValueError, match="stream's rows"):
        tfused.fused_ppr_iteration(topo, val, topo.slice_row,
                                   *[torch.empty((80, 4), device="meta")] * 2, alpha=ALPHA)


def test_launch_geometry_rejects_oversized_tiles():
    threads, smem, vec = launch_geometry(16, 256)
    assert threads == 256 and smem == 8 * 4 * (4 * 256 + 356) and vec == 4
    assert launch_geometry(3, 32)[2] == 1 and launch_geometry(1024, 32)[2] == 4
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(16, 4096)       # the staged slices exceed the budget
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(16, 48)         # not a whole number of warp steps
    with pytest.raises(ValueError):
        launch_geometry(2048, 256)


# ---------------------------------------------------------------------------
# the dst stream both kernels read
# ---------------------------------------------------------------------------
def _hub_graph(v=1200, e=4000, hub=5, hub_in=900, seed=11):
    """Edges into ``hub`` from ``hub_in`` sources (a row many slices and
    chunks long), random edges elsewhere, dst vertices 500..599 with no
    in-edge (an empty block of 64 at v_tile=64: 512..575), a ragged last
    block (1200 = 18·64 + 48), sources below v-60 (dangling tail)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.choice(v - 60, hub_in, replace=False),
                          rng.integers(0, v - 60, e)])
    dst = np.concatenate([np.full(hub_in, hub), rng.integers(0, v, e)])
    dst = np.where((dst >= 500) & (dst < 600), dst - 300, dst)
    return rcoo.COOGraph.from_edges(src, dst, v)


def _stream_sources(g, v_tile=64, packet=32):
    tg = _port(g)
    return {"blocked": tcoo.BlockedCOO.build(tg, v_tile=v_tile, packet=packet),
            "fused": tfused.build_fused_layout(tg, v_tile, packet)}


@pytest.mark.parametrize("source", ["blocked", "fused"])
def test_dst_stream_covers_every_real_edge_once_sorted_by_dst(source):
    g = _hub_graph()
    src = _stream_sources(g)[source]
    st = build_dst_stream(src)
    padded = (src.val if source == "blocked" else src.val2).size
    assert padded > g.num_edges == st.num_edges         # every pad dropped
    assert np.all(st.val > 0)
    rows = np.repeat(np.arange(st.num_rows), np.diff(st.row_ptr))
    assert np.all(np.diff(rows) >= 0)                   # sorted by dst
    assert np.array_equal(st.nz_rows, np.unique(rows))  # the rows with an edge
    got = sorted(zip(rows.tolist(), st.col.tolist(), st.val.tolist()))
    want = sorted(zip(g.x.tolist(), g.y.tolist(), g.val.tolist()))
    assert got == want                                  # each real edge once
    assert st.num_rows == (src.n_dst * src.v_tile if source == "blocked"
                           else g.num_vertices)


@pytest.mark.parametrize("fmt", [tfp.Q1_19, tfp.Q1_25], ids=lambda f: f.name)
def test_dst_stream_raw_values_equal_quantized_layout_rows(fmt):
    lay = _stream_sources(_hub_graph())["fused"]
    st = build_dst_stream(lay)
    rows = tfused.quantize_layout_rows(lay, fmt)
    real = np.concatenate([r[v != 0] for r, v in zip(rows, lay.row_val)])
    dst = np.concatenate([d * lay.v_tile + x[v != 0]
                          for d, (x, v) in enumerate(zip(lay.row_x, lay.row_val))])
    # the stream is the layout's real slots, stably sorted by dst
    want = real[np.argsort(dst, kind="stable")]
    assert np.array_equal(st.raw_values(fmt).view(np.uint32), want)
    assert np.array_equal(st.raw_values(None), st.val)


def test_dst_stream_slice_schedule_covers_every_edge_once():
    st = build_dst_stream(_stream_sources(_hub_graph())["fused"], slice_edges=64)
    e, s = st.num_edges, st.slice_edges
    assert st.num_slices == -(-e // s) and st.num_ctas == -(-st.num_slices // 8)
    starts = np.arange(st.num_slices) * s
    spans = np.minimum(starts + s, e) - starts
    assert spans.sum() == e and np.all(spans > 0)       # a partition of [0, E)
    # slice j's first edge lies in row nz_rows[slice_row[j]], the last edge
    # in nz_rows[slice_row[-1]]
    r = st.nz_rows[st.slice_row]
    firsts = np.append(starts, e - 1)
    assert np.all(st.row_ptr[r] <= firsts) and np.all(firsts < st.row_ptr[r + 1])
    # the default slice gives about a thousand CTAs at the paper's sizes
    assert build_dst_stream(_stream_sources(_hub_graph())["blocked"]).slice_edges == 32
    with pytest.raises(ValueError):
        build_dst_stream(_stream_sources(_hub_graph())["fused"], slice_edges=48)


def test_dst_stream_splits_a_row_longer_than_three_slices():
    g = _hub_graph()
    st = build_dst_stream(_stream_sources(g)["fused"], slice_edges=32)
    hub_len = st.row_ptr[6] - st.row_ptr[5]
    chunk = 8 * st.slice_edges                          # the edges of one CTA
    assert hub_len == int((g.x == 5).sum()) > 3 * chunk
    spanned = np.nonzero(st.nz_rows[st.slice_row[:-1]] == 5)[0]
    assert spanned.size >= hub_len // 32 - 1 > 3 * 8    # many slices, > 3 chunks
    assert np.all(np.diff(spanned) == 1)
    assert len({j // 8 for j in spanned}) > 3


def _emulate_slices(st, prod, fixed):
    """The kernels' SpMV and fix-up in numpy: a CTA's chunk of 8 slices
    leaves each row begun inside it in xp (its partial up to the chunk's
    end) and the partial of a row begun before it in carry[chunk]; each row
    is closed as xp[r] + carry[j] over the chunks j starting strictly inside
    it, in increasing j; an empty row is 0."""
    k = prod.shape[1]
    dt = np.uint32 if fixed else np.float64
    chunk = 8 * st.slice_edges
    xp = np.full((st.num_rows, k), 7, dt)               # garbage where unwritten
    carry = np.full((st.num_ctas, k), 7, dt)
    for c in range(st.num_ctas):
        e0, e1 = c * chunk, min((c + 1) * chunk, st.num_edges)
        q0, q1 = st.slice_row[8 * c], st.slice_row[min(8 * (c + 1), st.num_slices)]
        for r in st.nz_rows[q0:q1 + 1]:
            rs, re = st.row_ptr[r], st.row_ptr[r + 1]
            if rs < e1 and re > e0:
                part = prod[max(rs, e0):min(re, e1)].sum(0, dtype=dt)
                (xp[r] if rs >= e0 else carry[c])[:] = part
    out = np.zeros((st.num_rows, k), dt)
    for r in range(st.num_rows):
        rs, re = st.row_ptr[r], st.row_ptr[r + 1]
        if re == rs:
            continue
        x = xp[r].copy()
        j = rs // chunk + 1
        while j * chunk < re:
            x = (x + carry[j]).astype(dt)
            j += 1
        out[r] = x
    return out


@pytest.mark.parametrize("slice_edges", [32, 64, 1024])
@pytest.mark.parametrize("fixed", [False, True], ids=["f32", "Q1.25"])
def test_slice_partials_and_fixup_close_every_row(slice_edges, fixed):
    g = _hub_graph()
    st = build_dst_stream(_stream_sources(g)["fused"], slice_edges=slice_edges)
    rng = np.random.default_rng(2)
    fmt = tfp.Q1_25
    if fixed:
        p = rng.integers(0, 2 ** 32, (g.num_vertices, 4), dtype=np.uint64).astype(np.uint32)
        raw = st.raw_values(fmt).view(np.uint32).astype(np.uint64)
        prod = ((raw[:, None] * p[st.col].astype(np.uint64)) >> fmt.frac_bits)
        prod = (prod & 0xFFFFFFFF).astype(np.uint32)
        want = raw_to_numpy(coo_spmv_kernel(
            st.topology("cpu"), st.values("cpu", fmt), raw_to_torch(p),
            frac_bits=fmt.frac_bits))
        assert np.array_equal(_emulate_slices(st, prod, True), want)
    else:
        p = rng.random((g.num_vertices, 4))
        prod = st.val.astype(np.float64)[:, None] * p[st.col]
        want = np.zeros((st.num_rows, 4))
        np.add.at(want, np.repeat(np.arange(st.num_rows), np.diff(st.row_ptr)), prod)
        np.testing.assert_allclose(_emulate_slices(st, prod, False), want, rtol=1e-12)


@pytest.mark.parametrize("fixed", [False, True], ids=["f32", "Q1.25"])
def test_coo_spmv_empty_rows_and_empty_dst_block_are_zero(fixed):
    """Rows with no in-edge, a whole empty dst block (512..575) and the rows
    past |V| in the last block come out as 0, as in the reference."""
    g = _hub_graph()
    v = g.num_vertices
    rb = rcoo.BlockedCOO.build(g, v_tile=64, packet=32)
    tb = tcoo.BlockedCOO.build(_port(g), v_tile=64, packet=32)
    rng = np.random.default_rng(4)
    fmt = rfp.Q1_25 if fixed else None
    p = (rng.integers(1, 2 ** 20, (v, 4)).astype(np.uint32) if fixed
         else rng.random((v, 4)).astype(np.float32) + 0.5)
    pr = rops.pad_p_for_blocks(jnp.asarray(p), rb)
    out_r = np.asarray(rops.coo_spmv(rb, pr, fmt=fmt, interpret=True))
    pt = tops.pad_p_for_blocks(raw_to_torch(p) if fixed else torch.from_numpy(p), tb)
    out_t = tops.coo_spmv(tb, pt, fmt=None if fmt is None else _tfmt(fmt))
    got = raw_to_numpy(out_t) if fixed else out_t.numpy()
    empty = np.ones(tb.n_dst * tb.v_tile, bool)
    empty[g.x] = False
    assert empty[512:576].all() and empty[v:].all() and empty[:500].any()
    assert np.all(got[empty] == 0)
    if fixed:
        assert np.array_equal(got, out_r)
    else:
        np.testing.assert_allclose(got, out_r, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# kernel 2: fused_ppr_iteration
# ---------------------------------------------------------------------------
def _fused_case(g, fmt, k=4, seed=0, v_tile=128, packet=64, slice_edges=None):
    """Reference outputs and port outputs of one fused iteration (the port
    over the dst stream of its fused layout)."""
    v = g.num_vertices
    rng = np.random.default_rng(seed)
    pers = rng.choice(v, k, replace=False)
    rl = rfused.build_fused_layout(g, v_tile, packet)
    st = build_dst_stream(tfused.build_fused_layout(_port(g), v_tile, packet),
                          slice_edges=slice_edges)
    dang = np.zeros((rl.n_blk * v_tile, 1), np.float32)
    dang[:v, 0] = g.dangling
    dang_idx = torch.from_numpy(np.nonzero(g.dangling)[0].astype(np.int32))
    if fmt is None:
        p = (rng.random((v, k)) * 2 / v).astype(np.float32)
        vm = np.zeros((v, k), np.float32)
        vm[pers, np.arange(k)] = 1.0
        val_r = rl.val2
        p_t, vm_t = torch.from_numpy(p), torch.from_numpy(vm)
    else:
        p = rng.integers(0, fmt.scale // 32, (v, k)).astype(np.uint32)
        vm = np.zeros((v, k), np.uint32)
        vm[pers, np.arange(k)] = fmt.scale
        val_r = rfused.assemble_value_rows(rfused.quantize_layout_rows(rl, fmt), packet)
        p_t, vm_t = raw_to_torch(p), raw_to_torch(vm)
    tf = None if fmt is None else _tfmt(fmt)
    P_r, res_r = rfused.fused_ppr_iteration(
        *(jnp.asarray(a) for a in (rl.step_row, rl.step_dst, rl.step_src,
                                   rl.step_first, rl.step_last, rl.x2, rl.y2)),
        jnp.asarray(val_r), jnp.asarray(dang), jnp.asarray(vm), jnp.asarray(p),
        v_tile=v_tile, packet=packet, n_blk=rl.n_blk, num_steps=rl.num_steps,
        num_vertices=v, alpha=ALPHA, fmt=fmt, interpret=True)
    P_t, res_t = tfused.fused_ppr_iteration(
        st.topology("cpu"), st.values("cpu", tf), dang_idx, vm_t, p_t, alpha=ALPHA, fmt=tf)
    return np.asarray(P_r), np.asarray(res_r), P_t, res_t.numpy()


@pytest.mark.parametrize("fmt", [rfp.Q1_19, rfp.Q1_25], ids=lambda f: f.name)
def test_fused_iteration_fixed_raw_equal_to_pallas(fmt):
    P_r, res_r, P_t, res_t = _fused_case(_prime_graph(seed=1), fmt)
    assert np.array_equal(raw_to_numpy(P_t), P_r)            # raw-bit equality
    assert np.array_equal(res_t[1], res_r[1])                # ∞ row exact
    np.testing.assert_allclose(res_t[[0, 2]], res_r[[0, 2]], rtol=1e-4)


def test_fused_iteration_float_within_1e6_of_pallas():
    P_r, res_r, P_t, res_t = _fused_case(_prime_graph(seed=3), None)
    assert np.abs(P_t.numpy() - P_r).max() < 1e-6
    np.testing.assert_allclose(res_t, res_r, rtol=1e-4, atol=1e-7)


def test_fused_schedule_covers_every_row_once_and_empty_blocks():
    # vertices 200..399 receive no edges: their dst blocks own no rows
    rng = np.random.default_rng(5)
    g = rcoo.COOGraph.from_edges(rng.integers(0, 400, 900),
                                 rng.integers(0, 200, 900), 400)
    lay = tfused.build_fused_layout(_port(g), 64, 32)
    row_off, row_src = tfused.fused_schedule(lay)
    assert row_off[0] == 0 and row_off[-1] == lay.num_rows - 1 == row_src.shape[0]
    counts = np.diff(row_off)
    assert list(counts) == [r.shape[0] for r in lay.row_x]
    assert np.all(counts[4:] == 0)
    P_r, res_r, P_t, res_t = _fused_case(g, rfp.Q1_21, v_tile=64, packet=32)
    assert np.array_equal(raw_to_numpy(P_t), P_r)


@pytest.mark.parametrize("fmt", [None, rfp.Q1_25], ids=["f32", "Q1.25"])
def test_fused_iteration_over_a_hub_row_and_empty_block_matches_pallas(fmt):
    """A skewed graph (a 400-edge hub row, an empty dst block, a ragged last
    block) over 32-edge slices: the plain version over the stream against the
    Pallas kernel in interpret mode, at the present tolerances."""
    P_r, res_r, P_t, res_t = _fused_case(_hub_graph(), fmt, k=5, v_tile=64,
                                         packet=32, slice_edges=32)
    if fmt is None:
        assert np.abs(P_t.numpy() - P_r).max() < 1e-6
        np.testing.assert_allclose(P_t.numpy(), P_r, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(res_t, res_r, rtol=1e-4, atol=1e-7)
    else:
        assert np.array_equal(raw_to_numpy(P_t), P_r)
        assert np.array_equal(res_t[1], res_r[1])
        np.testing.assert_allclose(res_t[[0, 2]], res_r[[0, 2]], rtol=1e-4)


def test_dangling_mass_plain_wraps_like_the_reference():
    v, k = 300, 5
    rng = np.random.default_rng(9)
    p = rng.integers(0, 2**32, (v, k), dtype=np.uint64).astype(np.uint32)
    dang = rng.random(v) < 0.5
    ref = np.asarray(rppr._fixed_dangling_mass(jnp.asarray(dang.astype(np.uint32)),
                                               jnp.asarray(p)))
    idx = torch.from_numpy(np.nonzero(dang)[0].astype(np.int32))
    got = tfused.dangling_mass(raw_to_torch(p), idx, fixed=True)
    assert np.array_equal(raw_to_numpy(got), ref)
