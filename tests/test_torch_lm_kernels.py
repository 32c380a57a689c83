"""Port parity, LM kernels: the plain versions of ``flash_attention`` and
``quantized_matmul`` against the JAX reference's Pallas kernels (interpret
mode, as the reference's own tests run them on the CPU), and the port's
``quantize_weights`` bit for bit against the reference's.

Fixtures are the reference tests' own (``tests/test_flash_attention.py``,
``tests/test_kernels.py:75-95``).  The CUDA kernels themselves are held
against these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, smoke_config  # noqa: E402
from repro.core import quantization as rquant  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models.attention import _attend as r_attend  # noqa: E402
from repro_torch.core import quantization as tquant  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_gqa  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# kernel 3: flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,skv,d,bq,bk,causal,window", [
    (128, 128, 64, 64, 64, True, 0),
    (256, 256, 32, 128, 128, True, 0),
    (128, 256, 64, 64, 64, False, 0),     # cross-attention-like
    (256, 256, 64, 64, 64, True, 64),     # local window
    (128, 128, 128, 128, 128, True, 32),  # window < block
])
def test_flash_plain_matches_pallas(sq, skv, d, bq, bk, causal, window):
    """rtol = atol = 2e-5, the reference's own tolerance for its kernel."""
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (rng.standard_normal((3, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, bq=bq, bk=bk,
                                  interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    ref = rref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window)
    np.testing.assert_allclose(tref.flash_attention_ref(_t(q), _t(k), _t(v), causal,
                                                        window).numpy(),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_gqa_matches_reference_attend():
    """The port's GQA wrapper against the reference model's ``_attend`` on the
    setup of ``test_flash_gqa_wrapper_matches_attention_module`` (rtol = atol =
    2e-4, that test's tolerance)."""
    cfg = dataclasses.replace(smoke_config(get_config("gemma2-27b")),
                              attn_softcap=0.0, compute_dtype="float32")
    rng = np.random.default_rng(0)
    b, s, h, kv, hd = 2, 128, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    want = r_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(s),
                    jnp.arange(s), cfg, causal=True)
    got = flash_attention_gqa(_t(q), _t(k), _t(v), causal=True, bq=64, bk=64)
    assert got.shape == (b, s, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_flash_fully_masked_rows_are_zero():
    """sq=256, skv=128, window=64, not causal: rows 191–255 have no valid key.

    The contract (``ref.flash_attention_ref``, and the docstring of the
    reference's ``flash_attention_pallas``) says such rows output 0, and the
    port does.  The Pallas kernel masks with a finite -1e30, so there every
    masked score gets weight exp(0) and those rows come out as the mean of V:
    the reference diverges from its own contract at
    ``src/repro/kernels/flash_attention.py:60-79``, as asserted last."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 256, 32)).astype(np.float32)
    k = rng.standard_normal((2, 128, 32)).astype(np.float32)
    v = rng.standard_normal((2, 128, 32)).astype(np.float32)
    kw = dict(causal=False, window=64)
    got = flash_attention(_t(q), _t(k), _t(v), bq=64, bk=64, **kw).numpy()
    assert np.array_equal(got[:, 191:], np.zeros_like(got[:, 191:]))
    assert np.abs(got[:, :191]).min(axis=-1).max() > 0
    oracle = rref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-5, atol=2e-5)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bk=64,
        interpret=True, **kw))
    np.testing.assert_allclose(pallas[:, 191:], np.broadcast_to(
        v.mean(axis=1, keepdims=True), pallas[:, 191:].shape), rtol=1e-5, atol=1e-6)


def test_flash_block_shape_check():
    q = torch.zeros((1, 100, 64))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, bq=64, bk=64)
    with pytest.raises(ValueError):
        flash_attention_gqa(q[:, :, None], q[:, :, None], q[:, :, None], bq=64, bk=64)


# ---------------------------------------------------------------------------
# kernel 4: quantized matmul, and its quantizer
# ---------------------------------------------------------------------------
MM_SHAPES = [
    (128, 128, 128, 128, 128, 128),
    (256, 384, 512, 128, 128, 128),
    (128, 256, 128, 64, 64, 64),
]


def _weights(k, n, seed, zero_col=False):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0
    return w


@pytest.mark.parametrize("k,n,zero_col", [(128, 128, False), (384, 512, False),
                                          (256, 128, False), (256, 128, True)],
                         ids=["128x128", "384x512", "256x128", "zero-column"])
def test_quantize_weights_bit_identical(k, n, zero_col):
    w = _weights(k, n, k + n, zero_col)
    want = rquant.quantize_weights(jnp.asarray(w))
    got = tquant.quantize_weights(_t(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(got.scale.numpy().view(np.uint32),
                          np.asarray(want.scale).view(np.uint32))
    if zero_col:
        assert got.scale[3].item() == 1.0 and not got.q[:, 3].any()
    deq = tquant.dequantize(got)
    assert np.array_equal(deq.numpy(), np.asarray(rquant.dequantize(want)))
    x = _t(w * 37.0)
    assert np.array_equal(tquant.truncate_to_grid(x, 6).numpy(),
                          np.asarray(rquant.truncate_to_grid(jnp.asarray(w * 37.0), 6)))


@pytest.mark.parametrize("m,k,n,bm,bn,bk", MM_SHAPES)
def test_quantized_matmul_plain_matches_pallas(m, k, n, bm, bn, bk):
    """rtol = atol = 1e-4, the reference's tolerance for its kernel."""
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    qt = rquant.quantize_weights(jnp.asarray(w))
    want = rops.quantized_matmul(jnp.asarray(a), qt.q, qt.scale, interpret=True,
                                 bm=bm, bn=bn, bk=bk)
    tq = tquant.quantize_weights(_t(w))
    got = tops.quantized_matmul(_t(a), tq.q, tq.scale, bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tref.quantized_matmul_ref(_t(a), tq.q, tq.scale).numpy(),
        np.asarray(rref.quantized_matmul_ref(jnp.asarray(a), qt.q, qt.scale)),
        rtol=1e-4, atol=1e-4)


def test_quantized_matmul_shape_check():
    a = torch.zeros((100, 128))
    with pytest.raises(ValueError):
        tops.quantized_matmul(a, torch.zeros((128, 128), dtype=torch.int8),
                              torch.ones((128,)))
