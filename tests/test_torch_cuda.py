"""The CUDA kernels on the card against their plain PyTorch versions.

Every test takes the ``cuda`` fixture, which skips on a host without a CUDA
card: the hand-written kernels run only there.  This file imports no JAX (the
card's machine has none), so on a GPU host it runs as

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import raw_to_torch  # noqa: E402
from repro_torch.core import coo as tcoo  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402
from repro_torch.core.coo import COOGraph  # noqa: E402
from repro_torch.graphs import erdos_renyi  # noqa: E402
from repro_torch.kernels import fused_ppr as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

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


@pytest.mark.parametrize("fmt", [None, tfp.Q1_19], ids=["f32", "Q1.19"])
def test_cuda_fused_iteration_matches_plain(cuda, fmt):
    g = _prime_graph(seed=4)
    lay = tfused.build_fused_layout(g, 128, 64)
    row_off, row_src = (torch.from_numpy(a) for a in tfused.fused_schedule(lay))
    x2 = torch.from_numpy(lay.x2.astype(np.int16))
    y2 = torch.from_numpy(lay.y2.astype(np.int16))
    dang_idx = torch.from_numpy(np.nonzero(g.dangling)[0].astype(np.int32))
    rng = np.random.default_rng(1)
    p = torch.from_numpy((rng.random((V_PRIME, 8)) / 100).astype(np.float32))
    vm = torch.zeros((V_PRIME, 8))
    vm[torch.arange(8) * 70, torch.arange(8)] = 1.0
    if fmt is None:
        val2 = torch.from_numpy(lay.val2)
    else:
        val2 = raw_to_torch(tfused.assemble_value_rows(
            tfused.quantize_layout_rows(lay, fmt), 64))
        p, vm = fmt.from_float(p), fmt.from_float(vm)
    args = (row_off, row_src, x2, y2, val2, dang_idx, vm, p)
    kw = dict(v_tile=128, packet=64, n_blk=lay.n_blk, num_vertices=V_PRIME,
              alpha=ALPHA, fmt=fmt)
    before = tfused.fused_ppr_iteration.launches
    P_k, res_k = tfused.fused_ppr_iteration(*(a.to(cuda) for a in args), **kw)
    assert tfused.fused_ppr_iteration.launches == before + 1
    P_p, res_p = tfused.fused_ppr_iteration(*args, **kw)
    if fmt is None:
        torch.testing.assert_close(P_k.cpu(), P_p, rtol=1e-5, atol=1e-9)
    else:
        assert torch.equal(P_k.cpu(), P_p)
        assert torch.equal(res_k[1].cpu(), res_p[1])
    torch.testing.assert_close(res_k.cpu()[[0, 2]], res_p[[0, 2]], rtol=1e-4, atol=1e-6)
