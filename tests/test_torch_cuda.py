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
from repro_torch.core.quantization import quantize_weights  # noqa: E402
from repro_torch.kernels import fused_ppr as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.fixed_matmul import quantized_matmul_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_gqa,
    flash_attention_gqa_plain,
)

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
