"""The tensor-core designs of ``csrc/flash_attention.cu`` and
``csrc/fixed_matmul.cu``, checked on the CPU before any card runs them.

The CUDA kernels cannot run here, so these tests emulate in PyTorch what
they compute, with the tile sizes read from the sources
(``_build.csrc_constants``), and hold the emulations to the plain versions
at the kernels' own tolerances:

- flash attention in bf16: 128 query rows a CTA in two warpgroups of 64, kv
  tiles of ``BKV`` keys, the online softmax in the log2 domain, P as the sum
  of two bf16 terms for P·V (P rounded once to bf16, as FlashAttention and
  SDPA do, misses the tolerance: a test below shows it), the output rounded
  to bf16 once; and the kv tiles the
  kernel visits (a CTA's range, then each warpgroup's skip test) are
  exactly the tiles that hold an unmasked (query, key) pair;
- ``quantized_matmul``'s K split: ``plan_splits`` covers K exactly in whole
  k steps and fills one wave of the card's CTAs on decode-sized shapes, and
  the split-order fold of the partials equals the plain version.

These tests check the design, not the CUDA source: the tile sizes are read
from the sources, but the tile walk and the skip test below are a Python
copy of the kernel's expressions (``cta_tiles``, ``tile_live``), so an edit
to a ``.cu`` file alone leaves them green.  Only the on-card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` run the kernels.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quantization import quantize_weights  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fixed_matmul import (  # noqa: E402
    K_STEP,
    TILE_M,
    TILE_N,
    plan_splits,
    quantized_matmul_plain,
)
from repro_torch.kernels.flash_attention import flash_attention_gqa_plain  # noqa: E402

FA = _build.csrc_constants("flash_attention.cu")
BQ, BKV = FA["BQ"], FA["BKV"]
WG_ROWS = 64                      # rows of a consumer warpgroup (wgmma's M)
# CTAs an H100 SXM runs at once, by activation type: 132 SMs times the CTAs
# of the type's kernel an SM holds (ptxas: float32 256 threads x 116
# registers, two; bf16 384 threads, __launch_bounds__(384, 1), one)
H100_SLOTS = {torch.float32: 264, torch.bfloat16: 132}
# the kernels' bf16 tolerance (tests/test_torch_cuda.py, chip_smoke.py)
ATTN_TOL_BF16 = dict(rtol=2 ** -7, atol=1e-3)
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# flash attention: the kernel's tile walk, mirrored
# ---------------------------------------------------------------------------
def cta_tiles(q0, sq, skv, causal, window):
    """[t_lo, t_hi): the kv tiles a CTA at query row q0 loads."""
    k_lo, k_hi = 0, skv
    if causal:
        k_hi = min(skv, min(q0 + BQ, sq))
    if window > 0:
        k_lo = max(0, q0 - window + 1)
    return k_lo // BKV, (k_hi + BKV - 1) // BKV


def tile_live(t, qa, qb, skv, causal, window):
    """The warpgroup of rows [qa, qb] computes tile t (else only releases it)."""
    k0 = t * BKV
    k_last = min(k0 + BKV, skv) - 1
    return (qa <= qb and (not causal or k0 <= qb)
            and (window <= 0 or k_last >= qa - window + 1))


def valid_mask(sq, skv, causal, window):
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def warpgroups(sq):
    """(CTA first row, warpgroup first row, last row) of every warpgroup with rows."""
    for q0 in range(0, sq, BQ):
        for cw in range(BQ // WG_ROWS):
            qa = q0 + WG_ROWS * cw
            qb = min(qa + WG_ROWS, sq) - 1
            if qa <= qb:
                yield q0, qa, qb


def emulate_flash_bf16(q, k, v, *, causal, window, p_terms=2):
    """What flash_attention_tc_kernel computes: q [B,Sq,H,d], k/v
    [B,Skv,KV,d] bf16 → [B,Sq,H,d] bf16.  P·V takes P as ``p_terms`` bf16
    terms: the kernel's 2 (P = hi + lo, hi = bf16(P), lo = bf16(P - hi)),
    or 1 (P rounded once)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    mask = valid_mask(sq, skv, causal, window)
    out = torch.zeros(q.shape, dtype=torch.float32)
    neg_inf = torch.tensor(-math.inf)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // kvh)
            keys_all = k[bi, :, kv].float()
            vals_all = v[bi, :, kv].float()
            for q0, qa, qb in warpgroups(sq):
                qrows = q[bi, qa:qb + 1, hi].float()
                m = torch.full((qb - qa + 1,), -math.inf)
                l = torch.zeros(qb - qa + 1)
                acc = torch.zeros((qb - qa + 1, d))
                t_lo, t_hi = cta_tiles(q0, sq, skv, causal, window)
                for t in range(t_lo, t_hi):
                    if not tile_live(t, qa, qb, skv, causal, window):
                        continue
                    k0, k1 = t * BKV, min(t * BKV + BKV, skv)
                    s = (qrows @ keys_all[k0:k1].T) * scale_log2
                    s = torch.where(mask[qa:qb + 1, k0:k1], s, neg_inf)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    base = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
                    alpha = torch.exp2(m - base)
                    p = torch.exp2(s - base[:, None])
                    l = l * alpha + p.sum(dim=1)
                    p_hi = p.to(torch.bfloat16).float()
                    pv = p_hi @ vals_all[k0:k1]
                    if p_terms == 2:
                        pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vals_all[k0:k1]
                    acc = acc * alpha[:, None] + pv
                    m = m_new
                inv = torch.where(l > 0, 1.0 / l, torch.zeros(()))
                out[bi, qa:qb + 1, hi] = torch.where(l[:, None] > 0, acc * inv[:, None],
                                                     torch.zeros(()))
    return out.to(torch.bfloat16)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("b,sq,skv,h,kvh,causal,window", [
    (1, 256, 256, 2, 1, True, 0),        # causal, MQA
    (1, 300, 300, 4, 2, True, 100),      # GQA, window, ragged q and kv tiles
    (2, 200, 136, 2, 2, False, 0),       # cross-attention-like, ragged
    (1, 256, 128, 2, 1, False, 64),      # rows 191-255 fully masked
], ids=["causal", "gqa-window-ragged", "noncausal-ragged", "fully-masked"])
def test_flash_bf16_design_matches_plain(d, b, sq, skv, h, kvh, causal, window):
    """The emulated tensor-core kernel (P as two bf16 terms) stays within the
    bf16 tolerance of the plain version; fully masked rows are exactly 0."""
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = _bf16(rng, (b, sq, h, d)), _bf16(rng, (b, skv, kvh, d)), _bf16(rng, (b, skv, kvh, d))
    got = emulate_flash_bf16(q, k, v, causal=causal, window=window)
    want = flash_attention_gqa_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL_BF16)
    dead = ~valid_mask(sq, skv, causal, window).any(dim=1)
    assert torch.equal(got[:, dead].float(), torch.zeros_like(got[:, dead].float()))


def test_flash_p_rounded_once_to_bf16_misses_the_tolerance():
    """Why the kernel splits P: rounded once to bf16 (2^-9 relative), P's
    error reaches ~4e-3 where rows with few keys cancel to a small output,
    past atol 1e-3 + rtol 2^-7."""
    rng = np.random.default_rng(256 + 256 + 256)
    q, k, v = _bf16(rng, (1, 256, 2, 256)), _bf16(rng, (1, 256, 1, 256)), _bf16(rng, (1, 256, 1, 256))
    want = flash_attention_gqa_plain(q, k, v, causal=True).float()
    once = emulate_flash_bf16(q, k, v, causal=True, window=0, p_terms=1).float()
    assert not torch.allclose(once, want, **ATTN_TOL_BF16)
    twice = emulate_flash_bf16(q, k, v, causal=True, window=0).float()
    assert torch.allclose(twice, want, **ATTN_TOL_BF16)


@pytest.mark.parametrize("sq,skv", [(1024, 1024), (300, 300), (200, 136), (100, 700), (64, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1), (True, 100), (True, 1024),
                                           (False, 0), (False, 64), (False, 257)])
def test_flash_tiles_visited_are_exactly_the_unmasked_ones(sq, skv, causal, window):
    """Per warpgroup, the tiles it computes are exactly those holding an
    unmasked pair of its rows, and all of them lie in its CTA's loaded range."""
    mask = valid_mask(sq, skv, causal, window)
    n_tiles = (skv + BKV - 1) // BKV
    for q0, qa, qb in warpgroups(sq):
        t_lo, t_hi = cta_tiles(q0, sq, skv, causal, window)
        visited = {t for t in range(t_lo, t_hi) if tile_live(t, qa, qb, skv, causal, window)}
        needed = {t for t in range(n_tiles)
                  if mask[qa:qb + 1, t * BKV:(t + 1) * BKV].any()}
        assert visited == needed, (q0, qa, qb, sorted(visited ^ needed))


# ---------------------------------------------------------------------------
# quantized_matmul: the K split
# ---------------------------------------------------------------------------
MM_M128 = [(128, 2048, 16384), (128, 16384, 2048)]   # chip_smoke.py's decode-sized cases


def split_steps(steps, splits):
    """The k-step ranges [begin, end) of the splits in split order, as the
    kernels' ``split_begin`` computes them."""
    return [(z * steps // splits, (z + 1) * steps // splits) for z in range(splits)]


def _tiles(m, n):
    return -(-m // TILE_M) * -(-n // TILE_N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", MM_M128)
def test_split_plan_fills_the_card_on_decode_shapes(dtype, m, k, n):
    """The plan's CTAs run in one wave that one more split would overflow:
    the most splits the card holds at once (a second wave costs more than
    the few idle slots, as chip_smoke.py's split sweep measures)."""
    slots = H100_SLOTS[dtype]
    splits = plan_splits(m, n, k, K_STEP[dtype], slots)
    assert _tiles(m, n) * splits <= slots < _tiles(m, n) * (splits + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", MM_M128 + [
    (4096, 2048, 16384), (4096, 16384, 2048), (128, 4096, 256), (72, 136, 200),
    (8, 8, 8), (128, 128, 128), (1, 16384, 8), (256, 1000, 512)])
def test_split_plan_covers_k_exactly_in_whole_steps(dtype, m, k, n):
    step = K_STEP[dtype]
    steps = -(-k // step)
    splits = plan_splits(m, n, k, step, H100_SLOTS[dtype])
    assert 1 <= splits <= max(1, steps)
    if _tiles(m, n) >= H100_SLOTS[dtype]:
        assert splits == 1
    ranges = split_steps(steps, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == steps
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(e > b for b, e in ranges)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(128, 4096, 256), (72, 2048, 200), (128, 16384, 128)])
def test_split_order_fold_matches_plain(dtype, m, k, n):
    """Partials over each split's k steps, folded in split order and scaled
    once, equal the plain version within rtol = atol = 1e-4."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dtype)
    qt = quantize_weights(torch.from_numpy((rng.standard_normal((k, n)) / math.sqrt(k))
                                           .astype(np.float32)))
    step = K_STEP[dtype]
    splits = plan_splits(m, n, k, step, H100_SLOTS[dtype])
    assert splits > 1
    folded = None
    for b, e in split_steps(-(-k // step), splits):
        lo, hi = b * step, min(e * step, k)
        part = a[:, lo:hi].float() @ qt.q[lo:hi].float()
        folded = part if folded is None else folded + part
    got = folded * qt.scale[None, :]
    torch.testing.assert_close(got, quantized_matmul_plain(a, qt.q, qt.scale),
                               rtol=1e-4, atol=1e-4)
