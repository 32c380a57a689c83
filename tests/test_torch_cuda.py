"""The CUDA kernels on the card against their plain PyTorch versions.

Every test takes the ``cuda`` fixture, which skips on a host without a CUDA
card: the hand-written kernels run only there.  This file imports no JAX (the
card's machine has none), so on a GPU host it runs as

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import coo as tcoo  # noqa: E402
from repro_torch.core import fixed_point as tfp  # noqa: E402
from repro_torch.core.coo import COOGraph  # noqa: E402
from repro_torch.graphs import erdos_renyi  # noqa: E402
from repro_torch.core.quantization import quantize_weights  # noqa: E402
from repro_torch.kernels import fused_ppr as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.coo_spmv import coo_spmv_kernel, coo_spmv_plain  # noqa: E402
from repro_torch.kernels.dst_stream import build_dst_stream  # noqa: E402
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
