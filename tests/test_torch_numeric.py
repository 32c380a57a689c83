"""Port parity, numeric core: ``repro_torch`` against the JAX reference ``repro``.

The same numpy inputs, made from a seed, go through both packages.  Fixed
point must be raw-bit identical; float32 within the reference's own 1e-6 on
PPR states.  Raw values cross over as numpy uint32 (``repro_torch.convert``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import coo as rcoo  # noqa: E402
from repro.core import fixed_point as rfp  # noqa: E402
from repro.core import ppr as rppr  # noqa: E402
from repro.core import spmv as rspmv  # noqa: E402
from repro.graphs import generate as rgen  # noqa: E402
from repro.graphs import reference as rref  # noqa: E402
from repro.kernels import fused_ppr as rfused  # noqa: E402
from repro_torch.convert import graph_from_arrays, raw_to_numpy, raw_to_torch  # noqa: E402
from repro_torch.core import coo as tcoo  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402
from repro_torch.core import ppr as tppr  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.graphs import generate as tgen  # noqa: E402
from repro_torch.graphs import reference as tref  # noqa: E402
from repro_torch.kernels import fused_ppr as tfused  # noqa: E402

# tests/test_fixed_point.py's formats, plus the widest: Q1.31
FORMATS = list(rfp.PAPER_FORMATS.values()) + [
    rfp.QFormat(2, 14), rfp.QFormat(1, 30), rfp.QFormat(4, 8), rfp.QFormat(1, 31)]
V_PRIME = 641


def _tfmt(fmt):
    return tfp.QFormat(fmt.int_bits, fmt.frac_bits)


def _graph(v=V_PRIME, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    # sources capped below v-40 ⇒ the tail vertices are dangling
    return rcoo.COOGraph.from_edges(rng.integers(0, v - 40, e),
                                    rng.integers(0, v, e), v)


def _port(g):
    return graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices)


@pytest.mark.parametrize("value", [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -1])
def test_wrap_u32_exact_at_the_edges(value):
    got = tfp.wrap_u32(torch.tensor([value], dtype=torch.int64))
    assert got.dtype == torch.int32
    assert int(raw_to_numpy(got)[0]) == value % 2**32
    assert int(tfp.widen_u32(got)[0]) == value % 2**32


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_mul_add_raw_equal_to_reference(fmt):
    rng = np.random.default_rng(fmt.total_bits * 100 + fmt.frac_bits)
    n = 4096
    a = rng.integers(0, fmt.max_raw + 1, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, fmt.max_raw + 1, n, dtype=np.uint64).astype(np.uint32)
    # near max_raw: the products and sums that wrap or saturate
    a[:64] = fmt.max_raw - rng.integers(0, 4, 64)
    b[:64] = fmt.max_raw - rng.integers(0, 4, 64)
    tf = _tfmt(fmt)
    ta, tb = raw_to_torch(a), raw_to_torch(b)
    mul_r = np.asarray(fmt.mul(jnp.asarray(a), jnp.asarray(b)))
    add_r = np.asarray(fmt.add(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(raw_to_numpy(tf.mul(ta, tb)), mul_r)
    assert np.array_equal(raw_to_numpy(tf.add(ta, tb)), add_r)
    # and both equal Python's exact (a*b) >> f, taken mod 2^32
    exact = np.array([((int(x) * int(y)) >> fmt.frac_bits) % 2**32
                      for x, y in zip(a[:256], b[:256])], np.uint32)
    assert np.array_equal(mul_r[:256], exact)


@pytest.mark.parametrize("fmt", list(rfp.PAPER_FORMATS.values()), ids=lambda f: f.name)
def test_conversions_match_reference(fmt):
    rng = np.random.default_rng(fmt.frac_bits)
    x = np.concatenate([rng.random(512).astype(np.float32),
                        np.array([0.0, 1.0, 1.999, 2.5, -0.3], np.float32)])
    tf = _tfmt(fmt)
    raw_r = np.asarray(fmt.from_float(jnp.asarray(x)))
    raw_t = tf.from_float(torch.from_numpy(x))
    assert np.array_equal(raw_to_numpy(raw_t), raw_r)
    assert np.array_equal(tf.to_float(raw_t).numpy(),
                          np.asarray(fmt.to_float(jnp.asarray(raw_r))))
    assert np.array_equal(tf.quantize_f32(torch.from_numpy(x)).numpy(),
                          np.asarray(fmt.quantize_f32(jnp.asarray(x))))
    wide = (x * fmt.scale).astype(np.float32)
    assert np.array_equal(raw_to_numpy(tf.quantize_raw(torch.from_numpy(wide))),
                          np.asarray(fmt.quantize_raw(jnp.asarray(wide))))


def test_format_for_bits_matches_reference():
    for bits in range(2, 33):
        assert _tfmt(rfp.format_for_bits(bits)) == tfp.format_for_bits(bits)
    for bad in (1, 0, True, 2.5):
        with pytest.raises(ValueError):
            tfp.format_for_bits(bad)
    assert {k: _tfmt(v) for k, v in rfp.PAPER_FORMATS.items()} == tfp.PAPER_FORMATS


@pytest.mark.parametrize("v,e,v_tile,packet", [(641, 2500, 128, 64), (300, 2000, 64, 32)])
def test_blocked_coo_build_array_equal(v, e, v_tile, packet):
    g = rgen.erdos_renyi(v, e, seed=v)
    rb = rcoo.BlockedCOO.build(g, v_tile=v_tile, packet=packet)
    tb = tcoo.BlockedCOO.build(_port(g), v_tile=v_tile, packet=packet)
    for field in ("x_local", "y_local", "val", "block_starts"):
        assert np.array_equal(getattr(rb, field), getattr(tb, field)), field
    assert (rb.n_dst, rb.n_src, rb.num_packets) == (tb.n_dst, tb.n_src, tb.num_packets)
    assert rb.pad_overhead == tb.pad_overhead
    assert rb.edge_stream_bytes() == tb.edge_stream_bytes()
    for ra, ta in zip(rb.packed_indices(), tb.packed_indices()):
        assert ra.dtype == ta.dtype == np.uint16 and np.array_equal(ra, ta)
    assert np.array_equal(g.quantized_val(rfp.Q1_25),
                          _port(g).quantized_val(tfp.Q1_25))


def test_fused_layout_array_equal_fresh_and_incremental():
    g = _graph(seed=7)
    tg = _port(g)
    fields = ("x2", "y2", "val2", "step_row", "step_dst", "step_src",
              "step_first", "step_last")
    rl = rfused.build_fused_layout(g, 128, 64)
    tl = tfused.build_fused_layout(tg, 128, 64)
    for f in fields:
        assert np.array_equal(getattr(rl, f), getattr(tl, f)), f
    # incremental rebuild of dirty blocks reuses the clean blocks' arrays and
    # equals the fresh build; the reference's equals it but in step_src,
    # where it gives a clean block's rows the dst block
    # (src/repro/kernels/fused_ppr.py:190, ROADMAP.md §3)
    ri = rfused.build_fused_layout(g, 128, 64, reuse=rl, dirty=[0, 3])
    ti = tfused.build_fused_layout(tg, 128, 64, reuse=tl, dirty=[0, 3])
    for f in fields:
        assert np.array_equal(getattr(ti, f), getattr(rl, f)), f
        if f != "step_src":
            assert np.array_equal(getattr(ri, f), getattr(ti, f)), f
    clean = np.isin(ri.step_dst, [1, 2, 4]) & (ri.step_row != ri.num_rows - 1)
    clean[:ri.n_prologue] = False
    assert np.array_equal(ri.step_src[clean], ri.step_dst[clean])
    assert not np.array_equal(ri.step_src, rl.step_src)
    assert ti.row_x[1] is tl.row_x[1]
    rq = rfused.quantize_layout_rows(rl, rfp.Q1_19)
    tq = tfused.quantize_layout_rows(tl, tfp.Q1_19)
    assert np.array_equal(rfused.assemble_value_rows(rq, 64),
                          tfused.assemble_value_rows(tq, 64))
    with pytest.raises(ValueError):
        tfused.build_fused_layout(tg, 64, 64, reuse=tl, dirty=[0])


def test_spmv_paths_match_reference():
    g = _graph(seed=2)
    tg = _port(g)
    rng = np.random.default_rng(4)
    v, k = g.num_vertices, 8
    p = (rng.random((v, k)) / v).astype(np.float32)
    xs = (torch.from_numpy(tg.x), torch.from_numpy(tg.y))
    out_r = np.asarray(rspmv.spmv_float(jnp.asarray(g.x), jnp.asarray(g.y),
                                        jnp.asarray(g.val), jnp.asarray(p), v))
    out_t = tspmv.spmv_float(*xs, torch.from_numpy(tg.val), torch.from_numpy(p), v)
    np.testing.assert_allclose(out_t.numpy(), out_r, rtol=1e-5, atol=1e-8)
    fmt = rfp.Q1_25
    p_raw = rng.integers(0, 2**32, (v, k), dtype=np.uint64).astype(np.uint32)
    out_r = np.asarray(rspmv.spmv_fixed(
        jnp.asarray(g.x), jnp.asarray(g.y), jnp.asarray(g.quantized_val(fmt)),
        jnp.asarray(p_raw), v, fmt))
    out_t = tspmv.spmv_fixed(*xs, raw_to_torch(tg.quantized_val(_tfmt(fmt))),
                             raw_to_torch(p_raw), v, _tfmt(fmt))
    # full-range raw P: products and sums wrap mod 2^32 in both packages
    assert np.array_equal(raw_to_numpy(out_t), out_r)


@pytest.mark.parametrize("bits", [20, 22, 24, 26])
def test_run_ppr_fixed_raw_equal(bits):
    g = _graph(seed=bits)
    pers = np.array([1, 5, 600, 7, 640])
    cfg_r, cfg_t = rppr.PPRConfig(iterations=10), tppr.PPRConfig(iterations=10)
    fmt = rfp.format_for_bits(bits)
    P_r, d_r = rppr.run_ppr(g, pers, cfg_r, fmt)
    P_t, d_t = tppr.run_ppr(_port(g), pers, cfg_t, _tfmt(fmt), device="cpu")
    # both are raw/scale in float64: equal floats ⇔ equal raw bits
    assert np.array_equal(P_t, P_r)
    np.testing.assert_allclose(d_t, d_r, rtol=1e-5, atol=1e-9)


def test_run_ppr_float_within_1e6_and_batched():
    g = _graph(seed=11)
    pers = np.array([0, 9, 96, 300])
    P_r, d_r = rppr.run_ppr(g, pers, rppr.PPRConfig(iterations=10))
    P_t, d_t = tppr.run_ppr(_port(g), pers, tppr.PPRConfig(iterations=10),
                            device="cpu")
    assert np.abs(P_t - P_r).max() < 1e-6
    np.testing.assert_allclose(d_t, d_r, rtol=1e-4, atol=1e-7)
    verts = np.array([3, 4, 5, 6, 7])
    cfg_r, cfg_t = rppr.PPRConfig(kappa=2, iterations=5), tppr.PPRConfig(kappa=2, iterations=5)
    B_r = rppr.batched_ppr(g, verts, cfg_r, rfp.Q1_21)
    B_t = tppr.batched_ppr(_port(g), verts, cfg_t, tfp.Q1_21, device="cpu")
    assert np.array_equal(B_t, B_r)


def test_fixed_step_matches_reference_step():
    g = _graph(seed=13)
    tg = _port(g)
    fmt = rfp.Q1_23
    v = g.num_vertices
    pers = np.array([2, 77, 640], np.int32)
    assert rppr._fixed_consts(fmt, v, 0.85) == tuple(
        np.uint32(c) for c in tppr._fixed_consts(_tfmt(fmt), v, 0.85))
    step_r = rppr.make_ppr_fixed_step(fmt, v, 0.85)
    step_t = tppr.make_ppr_fixed_step(_tfmt(fmt), v, 0.85)
    V_r = rppr.personalization_matrix_fixed(v, jnp.asarray(pers), fmt)
    V_t = tppr.personalization_matrix_fixed(v, torch.from_numpy(pers), _tfmt(fmt))
    assert np.array_equal(raw_to_numpy(V_t), np.asarray(V_r))
    args_r = (jnp.asarray(g.x), jnp.asarray(g.y), jnp.asarray(g.quantized_val(fmt)),
              jnp.asarray(g.dangling))
    args_t = (torch.from_numpy(tg.x), torch.from_numpy(tg.y),
              raw_to_torch(tg.quantized_val(_tfmt(fmt))), torch.from_numpy(tg.dangling))
    P_r, P_t = V_r, V_t
    for _ in range(3):
        P_r = step_r(*args_r, V_r, P_r)
        P_t = step_t(*args_t, V_t, P_t)
        assert np.array_equal(raw_to_numpy(P_t), np.asarray(P_r))


def test_graph_generators_and_oracle_match_reference():
    for name, args in (("erdos_renyi", (500, 3000, 3)),
                       ("watts_strogatz", (400, 10, 0.1, 4)),
                       ("holme_kim_powerlaw", (600, 5, 0.1, 5))):
        gr, gt = getattr(rgen, name)(*args), getattr(tgen, name)(*args)
        for f in ("x", "y", "val", "dangling"):
            assert np.array_equal(getattr(gr, f), getattr(gt, f)), (name, f)
    g = _graph(seed=17)
    pers = np.array([1, 2, 3])
    assert np.array_equal(tref.ppr_reference(_port(g), pers, iterations=20),
                          rref.ppr_reference(g, pers, iterations=20))


def test_cuda_request_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for hosts without one")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tppr.run_ppr(_port(_graph(v=50, e=100)), np.array([1]))   # default: cuda
    assert resolve_device("cpu") == torch.device("cpu")
