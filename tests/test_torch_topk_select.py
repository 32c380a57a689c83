"""The top-K selection kernel's design (``csrc/topk_select.cu``), checked on
the CPU before any card runs it.

``emulate_select`` is a numpy copy of the kernel's two levels: CTAs walk
tiles of rows, a warp keeps each column's best entries in a sorted queue and
offers 32 rows at a time against its n-th entry, each CTA's n best go to
scratch, and the last CTA merges them a rank of every CTA at a time, up to
the first rank in which none passes the bar, in the kernel's order; a k
above ``KMAX`` in passes of at most ``KMAX``, each offering only entries
that rank after the last one the pass before it selected.  It is held to
the plain ``topk_dense`` on columns with ties, zeros, signed zeros and raw
values at and above 2^31, at tile sizes and grids that leave a ragged last
tile and CTAs with no tile; its float keys to the stable sort's order, NaNs
and infinities included.  It checks the design, not the source: the
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).  This file imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import topk_select as tsel  # noqa: E402
from repro_torch.ppr_serving.topk import topk_dense  # noqa: E402

CU = _build.csrc_constants("topk_select.cu")
NO_ID = 0x7FFFFFFF


def rank_columns(v: int, kappa: int, raw: bool, seed: int = 3) -> np.ndarray:
    """[V, κ] columns that cycle through eight patterns: heavy ties, fewer
    nonzeros than k, PPR-like scores, all zero, ties at the top, 0/1, signed
    zeros among small scores (raw: values at and above 2^31), and a spread
    one.  float32, or uint32 raw bits."""
    rng = np.random.default_rng(seed)
    P = np.zeros((v, kappa), np.float64)
    for j in range(kappa):
        pat = j % 8
        if pat == 0:
            P[:, j] = rng.integers(0, 4, v)                  # heavy ties
        elif pat == 1:
            P[:5, j] = [9, 7, 7, 5, 5][: min(5, v)]          # fewer nonzeros than k
        elif pat == 2:
            P[:, j] = rng.random(v) * 2.0 / v
            P[rng.integers(0, v), j] += 0.15                 # a PPR column
        elif pat == 4:
            P[::7, j] = 3                                    # ties at the top
        elif pat == 5:
            P[:, j] = rng.integers(0, 2, v)
        elif pat == 6:
            P[:, j] = rng.integers(0, 3, v) * 1e-3
        elif pat == 7:
            P[:, j] = rng.random(v) * 3.9
    if raw:
        bits = (P * 2**30).astype(np.uint64).astype(np.uint32)
        return bits + np.uint32(2**31) * (P > 2)
    out = P.astype(np.float32)
    for j in range(6, kappa, 8):                              # -0.0 beside +0.0
        col = out[:, j]
        col[(col == 0) & (rng.random(v) < 0.5)] = -0.0
    return out


def rank_key(bits: np.ndarray, is_float: bool) -> np.ndarray:
    """The kernel's ``rank_key``: uint32 keys whose order is the entries'."""
    b = bits.astype(np.uint32)
    if not is_float:
        return b
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    b = np.where(b == 0x80000000, np.uint32(0), b)
    key = np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(nan, np.uint32(0xFFFFFFFF), key)


def _before(a, b) -> bool:
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


class _Queue:
    """A warp's queue of one column: 32 (n <= 32) or 64 (key, id) entries,
    sorted."""

    def __init__(self, n: int):
        self.n = n
        self.e = [(0, NO_ID)] * (32 if n <= 32 else 64)

    def bar(self):
        return self.e[self.n - 1]

    def insert(self, c) -> None:
        if not _before(c, self.bar()):
            return
        pos = sum(_before(x, c) for x in self.e)
        self.e = (self.e[:pos] + [c] + self.e[pos:])[:len(self.e)]

    def offer(self, lanes) -> bool:
        """``lanes``: up to 32 (key, id) or None, tested against one bar (the
        ballot), then inserted in lane order; whether any passed."""
        bar = self.bar()
        hits = [c for c in lanes if c is not None and _before(c, bar)]
        for c in hits:
            self.insert(c)
        return bool(hits)


def emulate_select(P_bits: np.ndarray, n: int, exclude, is_float: bool,
                   tile_rows: int, grid: int, start=None):
    """(ids [κ, n], raw values [κ, n]) as one launch of the kernel selects
    them; ``start``: per column the (key, id) the selected entries rank
    after, or None."""
    v, kappa = P_bits.shape
    keys = rank_key(P_bits, is_float)
    n_tiles = -(-v // tile_rows)
    ids = np.zeros((kappa, n), np.int64)
    for col in range(kappa):
        ex = -1 if exclude is None else int(exclude[col])
        after = (lambda c: True) if start is None else (lambda c: _before(start[col], c))
        cand = []
        for cta in range(grid):
            q = _Queue(n)
            for t in range(cta, n_tiles, grid):
                row0 = t * tile_rows
                rows = min(tile_rows, v - row0)
                for r0 in range(0, rows, 32):
                    entries = [(int(keys[row0 + r, col]), row0 + r) if r < rows else None
                               for r in range(r0, r0 + 32)]
                    q.offer([c if c is not None and c[1] != ex and after(c) else None
                             for c in entries])
            cand.append(q.e[:n])
        # the last CTA: rank by rank over the CTAs, kMergeLoads loads a lane,
        # up to the first rank in which nothing passes the bar
        q = _Queue(n)
        for rank in range(n):
            layer = [c[rank] for c in cand]
            hit = False
            for j0 in range(0, grid, 32 * 4):
                for u in range(4):
                    hit |= q.offer([layer[j] if j < grid else None
                                    for j in range(j0 + 32 * u, j0 + 32 * (u + 1))])
            if not hit:
                break
        ids[col] = [i for _k, i in q.e[:n]]
    return ids, P_bits[ids, np.arange(kappa)[:, None]]


def emulate_passes(P_bits: np.ndarray, k: int, exclude, is_float: bool,
                   tile_rows: int, grid: int, kmax: int):
    """``emulate_select`` as the wrapper launches it: passes of at most
    ``kmax`` entries, each after the last entry of the pass before."""
    ids, vals, start = [], [], None
    for offset in range(0, k, kmax):
        i, b = emulate_select(P_bits, min(kmax, k - offset), exclude, is_float,
                              tile_rows, grid, start)
        ids.append(i)
        vals.append(b)
        start = list(zip(rank_key(b[:, -1], is_float).tolist(), i[:, -1].tolist()))
    return np.concatenate(ids, 1), np.concatenate(vals, 1)


def _as_torch(P: np.ndarray, raw: bool) -> torch.Tensor:
    return torch.from_numpy(P.view(np.int32) if raw else P)


def test_kmax_and_the_geometry_parse_from_the_source():
    assert tsel.KMAX == CU["kTopkMax"] >= 64 and tsel.KMAX % 32 == 0
    assert {"kSelectWarps", "kPrefetch", "kCtasPerSm"} <= set(CU)
    # the tile's shared memory holds a tile at every column-group width
    words = CU["kPrefetch"] * 32 * CU["kSelectWarps"] * 3 // 2
    for kappa in range(1, 2 * CU["kSelectWarps"] + 1):
        width = min(kappa, CU["kSelectWarps"])
        tile_rows, grid = tsel.select_geometry(1 << 20, kappa, 132)
        assert tile_rows * (width | 1) <= words
        assert grid == min(-(-(1 << 20) // tile_rows), CU["kCtasPerSm"] * 132)
    assert tsel.select_geometry(100, 16, 132)[1] == 1


def test_rank_key_orders_as_the_stable_sort_does():
    """NaN above +inf and tied with every NaN, -0.0 tied with +0.0."""
    x = np.array([np.nan, 1.0, -0.0, 0.0, np.inf, -np.nan, -1.0, -np.inf, 1e-45,
                  -1e-45, 3.4e38, -3.4e38], np.float32)
    keys = rank_key(x.view(np.uint32), True).astype(np.int64)
    order = np.lexsort((np.arange(x.size), -keys))
    want = torch.sort(torch.from_numpy(x), descending=True, stable=True).indices
    assert np.array_equal(order, want.numpy())


@pytest.mark.parametrize("raw", [False, True], ids=["float", "raw"])
@pytest.mark.parametrize("tile_rows,grid", [(16, 3), (32, 2), (64, 5), (256, 264)])
@pytest.mark.parametrize("exclude", ["absent", "inside", "outside"])
def test_emulated_two_level_selection_equals_topk_dense(raw, tile_rows, grid, exclude):
    """Tiles of 16 rows over 97 leave a ragged last one; 264 CTAs leave
    CTAs with no tile, whose queues hold only free slots."""
    v, kappa = 97, 16
    P = rank_columns(v, kappa, raw)
    ex = None
    if exclude == "inside":        # in or near each column's top k
        ex = np.array([0, 1, 50, 3, 7, 96] * 3, np.int32)[:kappa]
    elif exclude == "outside":
        ex = np.full(kappa, -1, np.int32)
    bits = P.view(np.uint32)
    for k in (1, 5, 8, 40):
        want_i, want_v = topk_dense(_as_torch(P, raw), k,
                                    exclude=None if ex is None else torch.from_numpy(ex))
        got_i, got_v = emulate_select(bits, k, ex, not raw, tile_rows, grid)
        assert np.array_equal(got_i, want_i.numpy())
        assert np.array_equal(got_v, want_v.numpy().view(np.uint32))


@pytest.mark.parametrize("raw", [False, True], ids=["float", "raw"])
@pytest.mark.parametrize("kmax", [8, 32, CU["kTopkMax"]])
@pytest.mark.parametrize("exclude", ["absent", "inside", "outside"])
def test_emulated_passes_join_into_topk_dense(raw, kmax, exclude):
    """A k above a pass's most in passes that each start after the last
    entry of the one before, across heavy ties and up to every vertex: the
    joined lists equal ``topk_dense``."""
    v, kappa = 97, 16
    P = rank_columns(v, kappa, raw, seed=11)
    ex = {"absent": None, "inside": np.array([0, 1, 50, 3, 7, 96] * 3, np.int32)[:kappa],
          "outside": np.full(kappa, v, np.int32)}[exclude]
    most = v - (ex is not None)
    for k in sorted({min(k, most) for k in (kmax - 1, kmax, kmax + 1, 2 * kmax + 3, most)}):
        want_i, want_v = topk_dense(_as_torch(P, raw), k,
                                    exclude=None if ex is None else torch.from_numpy(ex))
        got_i, got_v = emulate_passes(P.view(np.uint32), k, ex, not raw, 16, 3, kmax)
        assert np.array_equal(got_i, want_i.numpy()), k
        assert np.array_equal(got_v, want_v.numpy().view(np.uint32)), k


def test_emulation_at_the_kernel_geometry_with_many_tiles():
    """The wrapper's own tile size and grid for κ = 8 over 5,000 rows."""
    v, kappa = 5000, 8
    tile_rows, grid = tsel.select_geometry(v, kappa, 2)
    assert -(-v // tile_rows) > grid                   # CTAs walk several tiles
    for raw in (False, True):
        P = rank_columns(v, kappa, raw, seed=5)
        ex = np.arange(kappa, dtype=np.int32) * 611
        want_i, want_v = topk_dense(_as_torch(P, raw), 10, exclude=torch.from_numpy(ex))
        got_i, got_v = emulate_select(P.view(np.uint32), 10, ex, not raw, tile_rows, grid)
        assert np.array_equal(got_i, want_i.numpy())
        assert np.array_equal(got_v, want_v.numpy().view(np.uint32))


def test_topk_select_on_the_cpu_is_the_plain_version_and_launches_nothing():
    P = _as_torch(rank_columns(97, 6, True), True)
    before = tsel.topk_select.launches
    got = tsel.topk_select(P, 8, exclude=torch.arange(6))
    want = tsel.topk_select_plain(P, 8, exclude=torch.arange(6))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tsel.topk_select.launches == before


def test_topk_select_refuses_what_the_kernel_does_not_take():
    p = torch.empty((100, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tsel.topk_select(p, 10)
    with pytest.raises(ValueError, match="CUDA"):        # k above KMAX is taken
        tsel.topk_select(p, tsel.KMAX + 1, exclude=torch.zeros(16, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 raw bits or float32"):
        tsel.topk_select(p.double(), 10)
    with pytest.raises(ValueError, match="V=100"):
        tsel.topk_select(p, 100, exclude=torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="V=100"):
        tsel.topk_select(p, 0)


@pytest.mark.parametrize("dtype,k,error", [(torch.float64, 10, TypeError),
                                           (torch.int64, 10, TypeError),
                                           (torch.float32, 0, ValueError)])
def test_topk_dense_off_the_cpu_raises_and_never_sorts(monkeypatch, dtype, k, error):
    """Off the CPU ``topk_dense`` goes to the kernel's wrapper, which raises
    on a dtype it does not rank and on k < 1: nothing falls back to a sort."""
    def no_sort(*args, **kwargs):
        raise AssertionError("topk_dense sorted off the CPU")

    monkeypatch.setattr(torch, "sort", no_sort)
    with pytest.raises(error):
        topk_dense(torch.empty((100, 16), dtype=dtype, device="meta"), k)
