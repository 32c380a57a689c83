"""The host span timeline (``repro_torch.obs.trace.Timeline``): its bound,
its names, parents by containment per thread, and the spans the serving path
records into it — each submit, admission, each wave's stages and fused
steps — with answers bit-equal to an unarmed service and the
traced services' trees unchanged (``test_torch_obs``'s parity test run with
the timeline armed)."""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.coo import COOGraph  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.ppr_serving import PPRQuery, PPRService  # noqa: E402

WAVE_STAGES = ("ppr.wave.plan", "ppr.wave.iterate", "ppr.wave.topk",
               "ppr.wave.device_wait", "ppr.wave.resolve", "ppr.wave.callbacks")


@pytest.fixture
def armed():
    """A timeline armed for the test, disarmed after it whatever happens."""
    tl = trace.arm_timeline(1 << 16)
    yield tl
    trace.disarm_timeline()


def _graph(v=300, e=2400, seed=3):
    rng = np.random.default_rng(seed)
    return COOGraph.from_edges(rng.integers(0, v - 20, e), rng.integers(0, v, e), v)


def _serve(family, precision, vertices, iterations=10):
    svc = PPRService(kappa=4, iterations=iterations, device="cpu")
    svc.register_graph("g", _graph(), formats=[25], engine=family)
    recs = svc.run_batch([PPRQuery("g", int(v), k=5, precision=precision)
                          for v in vertices])
    return [(r.vertices.tolist(), np.asarray(r.scores).tolist()) for r in recs]


def _named(tl):
    return [trace.TIMELINE_SPANS[tl.name[i]] for i in range(tl.n)]


def test_bound_and_drop_count():
    tl = trace.Timeline(3)
    for i in range(5):
        tl.record(trace.span_id("ppr.step"), 10 * i, 10 * i + 5)
    assert (tl.n, tl.dropped) == (3, 2)
    assert list(tl.start[: tl.n]) == [0, 10, 20]
    st = tl.stats()["ppr.step"]
    assert st["count"] == 3
    assert st["total_s"] == st["self_s"] == pytest.approx(15e-9)
    with pytest.raises(ValueError):
        trace.Timeline(0)


@pytest.mark.parametrize("name", ["ppr.sumbit", "ppr.wave.topK", "", "wave"])
def test_unknown_span_name_raises(name):
    with pytest.raises(ValueError, match="unknown timeline span"):
        trace.span_id(name)


def test_every_span_name_has_its_own_id():
    ids = [trace.span_id(n) for n in trace.TIMELINE_SPANS]
    assert ids == list(range(len(trace.TIMELINE_SPANS)))


def test_parents_by_containment_per_thread():
    tl = trace.Timeline(16)
    wave, step, topk = (trace.span_id(n) for n in
                        ("ppr.wave", "ppr.step", "ppr.wave.topk"))
    tl.record(step, 110, 120)               # 0: inside 2 (recorded first)
    tl.record(step, 130, 140)               # 1: inside 2
    tl.record(wave, 100, 200, wave=7)       # 2: the root of this thread
    tl.record(topk, 150, 150)               # 3: a zero-length span inside 2
    tl.record(step, 250, 260)               # 4: after 2, a root
    other = threading.Thread(target=tl.record, args=(step, 105, 190))
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    parents = tl.parents()
    assert parents == [2, 2, -1, 2, -1, -1]  # 5 ran on another thread
    st = tl.stats()
    assert st["ppr.wave"]["total_s"] == pytest.approx(100e-9)
    assert st["ppr.wave"]["self_s"] == pytest.approx(80e-9)   # less 10 + 10 + 0
    assert st["ppr.step"]["count"] == 4


@pytest.mark.parametrize("capacity", [40_000, 1_000])
def test_threads_recording_at_once_lose_no_slot(capacity):
    """Eight threads record 5,000 spans each with the interpreter switching
    threads every few microseconds: every slot is claimed once, and each
    thread's spans survive whole (an unfull timeline) or the excess is
    counted as dropped."""
    tl = trace.Timeline(capacity)
    step = trace.span_id("ppr.step")

    def work(k):
        for j in range(5_000):
            tl.record(step, k * 10**6 + j, k * 10**6 + j + 1, wave=k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (tl.n, tl.dropped) == (min(capacity, 40_000), max(0, 40_000 - capacity))
    rows = {(tl.wave[i], tl.start[i]) for i in range(tl.n)}
    assert len(rows) == tl.n                    # no slot written twice
    assert all(tl.start[i] // 10**6 == tl.wave[i] and tl.end[i] == tl.start[i] + 1
               for i in range(tl.n))                   # no row mixes two spans
    if capacity == 40_000:
        assert rows == {(k, k * 10**6 + j) for k in range(8) for j in range(5_000)}


def test_equal_intervals_nest_in_recording_order():
    """A span recorded after an identical one is its parent (spans are
    recorded at their end, the outer one last)."""
    tl = trace.Timeline(4)
    tl.record(trace.span_id("ppr.step"), 5, 9)
    tl.record(trace.span_id("ppr.wave.iterate"), 5, 9)
    assert tl.parents() == [1, -1]


def test_off_is_an_empty_slot_and_leaves_answers_unchanged():
    assert trace.armed is None
    verts = [3, 17, 40, 41, 99, 150, 151]
    cold = _serve("fused", "Q1.25", verts)
    tl = trace.arm_timeline(1 << 12)
    try:
        hot = _serve("fused", "Q1.25", verts)
    finally:
        assert trace.disarm_timeline() is tl
    assert trace.armed is None and trace.disarm_timeline() is None
    assert hot == cold
    assert tl.n > 0 and tl.dropped == 0


@pytest.mark.parametrize("precision", ["Q1.25", None], ids=["q25", "f32"])
def test_fused_waves_record_each_stage_once_and_every_step(armed, precision):
    verts = [3, 17, 40, 41, 99, 150, 151, 200, 7, 8]      # 3 waves at κ = 4
    got = _serve("fused", precision, verts, iterations=6)
    trace.disarm_timeline()
    want = _serve("fused", precision, verts, iterations=6)
    trace.armed = armed                     # the fixture disarms it
    assert got == want
    names, parents = _named(armed), armed.parents()
    wave_rows = [i for i, n in enumerate(names) if n == "ppr.wave"]
    assert [armed.wave[w] for w in wave_rows] == [1, 2, 3]
    for w in wave_rows:
        kids = [i for i in range(armed.n) if parents[i] == w]
        assert sorted(names[i] for i in kids) == sorted(WAVE_STAGES)
        assert all(armed.wave[i] == armed.wave[w] for i in kids)
        it = [i for i in kids if names[i] == "ppr.wave.iterate"][0]
        steps = [i for i in range(armed.n) if parents[i] == it]
        assert [names[i] for i in steps] == ["ppr.step"] * 6
        assert sum(armed.end[i] - armed.start[i] for i in steps) <= \
            armed.end[it] - armed.start[it]
    assert names.count("ppr.step") == 3 * 6
    # every submit is a root outside any wave; the admission ran under flush
    subs = [i for i, n in enumerate(names) if n == "ppr.submit"]
    assert len(subs) == len(verts)
    assert all(parents[i] == -1 and armed.wave[i] == 0 for i in subs)
    assert names.count("ppr.admit") == 1


def test_timeline_bound_holds_under_a_full_service(armed):
    small = trace.arm_timeline(8)
    _serve("fused", "Q1.25", [1, 2, 3, 4, 5, 6, 7, 8])
    trace.armed = armed
    assert small.n == 8 and small.dropped > 0


@pytest.mark.parametrize("policy", ["no-exit", "exit", "checks-before-min",
                                    "min-past-budget"])
@pytest.mark.parametrize("tracing", [True, 0.5], ids=["traced", "sampled"])
@pytest.mark.parametrize("families", [("single", "single"), ("pallas", "fused")],
                         ids=["single", "fused"])
def test_traced_trees_equal_reference_with_the_timeline_armed(armed, families,
                                                              tracing, policy):
    """``test_torch_obs``'s parity test, as it is, with the timeline armed:
    the spans read their own clock, so the injected ticking clock sees the
    reads it saw, and the trees, answers and samples stay the reference's."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_obs

    test_torch_obs.test_traced_service_equal_reference(
        test_torch_obs._graph(), families, tracing, policy)
    assert trace.armed is armed
    names = _named(armed)
    assert names.count("ppr.wave") > 0
    assert names.count("ppr.submit") >= names.count("ppr.wave")
