"""Seeded inputs repeat exactly: graphs, query streams, arrivals, deltas."""
import numpy as np
import pytest

from portbench import arrivals, graphgen

SEEDS = [0, 7, 2**31 + 11, -5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dist", [{"dist": "uniform"}, {"dist": "zipf", "s": 0.99}])
def test_vertex_stream_repeats(seed, dist):
    a = arrivals.VertexStream(dist, 5000, seed, chunk=100)
    b = arrivals.VertexStream(dist, 5000, seed, chunk=100)
    xs = [a.next() for _ in range(350)]
    assert xs == [b.next() for _ in range(350)]
    assert all(0 <= x < 5000 for x in xs)
    c = arrivals.VertexStream(dist, 5000, seed + 1, chunk=100)
    assert xs != [c.next() for _ in range(350)]


def test_zipf_is_skewed_over_a_seeded_permutation():
    s = arrivals.VertexStream({"dist": "zipf", "s": 0.99}, 20000, 3)
    draws = s.draw(200000)
    counts = np.bincount(draws, minlength=20000)
    top = np.sort(counts)[::-1]
    # rank 1 carries 1/H ~ 0.095 of the mass at s = 0.99 over 20,000
    assert 0.08 < top[0] / draws.size < 0.11
    assert top[:200].sum() / draws.size > 0.5
    hot = arrivals.VertexStream({"dist": "zipf", "s": 0.99}, 20000, 4).draw(50000)
    assert np.bincount(hot, minlength=20000).argmax() != counts.argmax()


@pytest.mark.parametrize("seed", SEEDS)
def test_open_arrivals_exact_count_sorted_inside_window(seed):
    t = arrivals.open_arrivals(1234.5, 3.0, seed)
    assert t.shape == (3704,)
    assert np.all(np.diff(t) >= 0) and t[0] >= 0 and t[-1] < 3.0
    np.testing.assert_array_equal(t, arrivals.open_arrivals(1234.5, 3.0, seed))


def test_delta_times_follow_the_schedule():
    spec = {"first_s": 2.5, "every_s": 5.0}
    np.testing.assert_allclose(arrivals.delta_times(spec, 30.0),
                               [2.5, 7.5, 12.5, 17.5, 22.5, 27.5])
    assert arrivals.delta_times(None, 30.0).size == 0


@pytest.mark.parametrize("gen,spec", [
    ("erdos_renyi", {"num_vertices": 4000, "num_edges": 40000}),
    ("holme_kim_powerlaw", {"num_vertices": 4000, "m": 10, "p_triad": 0.1}),
])
def test_graphs_repeat_without_self_or_duplicate_edges(gen, spec):
    spec = dict(spec, generator=gen)
    s1, d1 = graphgen.make_graph(spec, arrivals.rng_for(9, "graph"))
    s2, d2 = graphgen.make_graph(spec, arrivals.rng_for(9, "graph"))
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    assert not np.any(s1 == d1)
    assert np.unique(s1 * 4000 + d1).size == s1.size
    if gen == "erdos_renyi":
        assert s1.size == 40000
    s3, _ = graphgen.make_graph(spec, arrivals.rng_for(10, "graph"))
    assert s3.size != s1.size or np.any(s3 != s1)


def test_delta_batch_repeats_and_removes_each_edge_once():
    src, _ = graphgen.erdos_renyi(3000, 30000, arrivals.rng_for(1, "graph"))
    a = graphgen.delta_batch(src, 3000, 6, 64, 32, arrivals.rng_for(1, "deltas"))
    b = graphgen.delta_batch(src, 3000, 6, 64, 32, arrivals.rng_for(1, "deltas"))
    for x, y in zip(a, b):
        for key in ("remove", "add_src", "add_dst"):
            np.testing.assert_array_equal(x[key], y[key])
    removed = np.concatenate([d["remove"] for d in a])
    assert removed.size == 6 * 32 and np.unique(removed).size == removed.size
    assert all(d["add_src"].size == 64 and d["add_dst"].max() < 3000 for d in a)
