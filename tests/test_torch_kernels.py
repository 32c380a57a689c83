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
    g = _port(erdos_renyi(300, 2000, seed=7))
    b = tcoo.BlockedCOO.build(g, v_tile=64, packet=32)
    ops = tops.spmv_operands(b, torch.device("cpu"), tfp.Q1_21)
    xp, yp = b.packed_indices()
    assert ops["x_local"].dtype == torch.int16
    assert np.array_equal(ops["x_local"].numpy().view(np.uint16).ravel(), xp)
    assert np.array_equal(ops["y_local"].numpy().view(np.uint16).ravel(), yp)
    packet_dst, _, _, _ = tops.packet_metadata(b)
    off = ops["dst_start"].numpy()
    assert off[0] == 0 and off[-1] == b.num_packets
    for d in range(b.n_dst):                       # dst-major contiguous ranges
        assert np.all(packet_dst[off[d]:off[d + 1]] == d)


def test_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda():
    meta = torch.device("meta")
    x = torch.empty((2, 32), dtype=torch.int16, device=meta)
    val = torch.empty((2, 32), dtype=torch.float32, device=meta)
    p = torch.empty((64, 4), dtype=torch.float32, device=meta)
    off = torch.empty(2, dtype=torch.int32, device=meta)
    src = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        coo_spmv_kernel(x, x, val, p, off, src, v_tile=64, packet=32, n_dst=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.dangling_mass(p, src, fixed=False)


def test_launch_geometry_rejects_oversized_tiles():
    threads, smem = launch_geometry(512, 16)
    assert threads % 16 == 0 and smem == 512 * 16 * 4
    assert launch_geometry(128, 3)[0] % 3 == 0
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(4096, 16)
    with pytest.raises(ValueError):
        launch_geometry(512, 2048)


# ---------------------------------------------------------------------------
# kernel 2: fused_ppr_iteration
# ---------------------------------------------------------------------------
def _fused_case(g, fmt, k=4, seed=0, v_tile=128, packet=64):
    """Reference outputs and port outputs of one fused iteration."""
    v = g.num_vertices
    rng = np.random.default_rng(seed)
    pers = rng.choice(v, k, replace=False)
    rl = rfused.build_fused_layout(g, v_tile, packet)
    tg = _port(g)
    frg_lay = tfused.build_fused_layout(tg, v_tile, packet)
    row_off, row_src = tfused.fused_schedule(frg_lay)
    dang = np.zeros((rl.n_blk * v_tile, 1), np.float32)
    dang[:v, 0] = g.dangling
    dang_idx = torch.from_numpy(np.nonzero(g.dangling)[0].astype(np.int32))
    if fmt is None:
        p = (rng.random((v, k)) * 2 / v).astype(np.float32)
        vm = np.zeros((v, k), np.float32)
        vm[pers, np.arange(k)] = 1.0
        val_r, val_t = rl.val2, torch.from_numpy(frg_lay.val2)
        p_t, vm_t = torch.from_numpy(p), torch.from_numpy(vm)
    else:
        p = rng.integers(0, fmt.scale // 32, (v, k)).astype(np.uint32)
        vm = np.zeros((v, k), np.uint32)
        vm[pers, np.arange(k)] = fmt.scale
        val_r = rfused.assemble_value_rows(rfused.quantize_layout_rows(rl, fmt), packet)
        val_t = raw_to_torch(tfused.assemble_value_rows(
            tfused.quantize_layout_rows(frg_lay, _tfmt(fmt)), packet))
        p_t, vm_t = raw_to_torch(p), raw_to_torch(vm)
    P_r, res_r = rfused.fused_ppr_iteration(
        *(jnp.asarray(a) for a in (rl.step_row, rl.step_dst, rl.step_src,
                                   rl.step_first, rl.step_last, rl.x2, rl.y2)),
        jnp.asarray(val_r), jnp.asarray(dang), jnp.asarray(vm), jnp.asarray(p),
        v_tile=v_tile, packet=packet, n_blk=rl.n_blk, num_steps=rl.num_steps,
        num_vertices=v, alpha=ALPHA, fmt=fmt, interpret=True)
    P_t, res_t = tfused.fused_ppr_iteration(
        torch.from_numpy(row_off), torch.from_numpy(row_src),
        torch.from_numpy(frg_lay.x2.astype(np.int16)),
        torch.from_numpy(frg_lay.y2.astype(np.int16)), val_t, dang_idx, vm_t, p_t,
        v_tile=v_tile, packet=packet, n_blk=frg_lay.n_blk, num_vertices=v,
        alpha=ALPHA, fmt=None if fmt is None else _tfmt(fmt))
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
