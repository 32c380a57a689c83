"""Port parity, adaptive precision and prefetch: ``core.metrics``,
``core.csr_compare``, the shadow estimator, the precision controller, the
prefetcher and ``PPRService``'s ``precision="auto"``/shadow/prefetch paths
against the JAX reference.

The same numpy inputs, made from seeds, go through both packages.  The
metrics, the estimator, the controller and the prefetcher are host code and
must agree exactly.  The service's auto path runs on the port's "single" and
"fused" families (plain PyTorch on the CPU) against the reference's "single"
(XLA) and "pallas" (its kernel in interpret mode) families: resolved
precisions, sampling decisions, promotions and demotions equal, fixed-point
answers raw-bit equal, float32 answers and shadow scores within 1e-6.
Mirrors ``tests/test_autotune.py:32-198`` and ``:306-377`` and
``tests/test_graph_updates.py:262`` and ``:331-400``, with ``run_batch`` and
``poll`` for the reference's deprecated ``serve`` and ``pump``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import autotune as rauto  # noqa: E402
from repro.autotune import controller as rctl_mod  # noqa: E402
from repro.core import csr_compare as rcsr  # noqa: E402
from repro.core import metrics as rmet  # noqa: E402
from repro.graph_updates import EdgeDelta as REdgeDelta  # noqa: E402
from repro.graphs import erdos_renyi, holme_kim_powerlaw  # noqa: E402
from repro.graphs import paper_graph_suite as rsuite  # noqa: E402
from repro.ppr_serving import PPRQuery as RQuery  # noqa: E402
from repro.ppr_serving import PPRService as RService  # noqa: E402
from repro.ppr_serving import prefetch as rpre  # noqa: E402
from repro_torch import autotune as tauto  # noqa: E402
from repro_torch.autotune import controller as tctl_mod  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import csr_compare as tcsr  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.graph_updates import EdgeDelta as TEdgeDelta  # noqa: E402
from repro_torch.graphs import paper_graph_suite as tsuite  # noqa: E402
from repro_torch.ppr_serving import FLOAT_KEY  # noqa: E402
from repro_torch.ppr_serving import PPRQuery as TQuery  # noqa: E402
from repro_torch.ppr_serving import PPRService as TService  # noqa: E402
from repro_torch.ppr_serving import prefetch as tpre  # noqa: E402

CPU = "cpu"
FAMILIES = [("single", "single"), ("pallas", "fused")]   # (reference, port)


def _port(g):
    return graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices)


@pytest.fixture(scope="module")
def graph():
    return holme_kim_powerlaw(300, m=3, seed=1)


@pytest.fixture(scope="module")
def delta_graph():
    return holme_kim_powerlaw(400, m=4, seed=2)


# ---------------------------------------------------------------------------
# core.metrics
# ---------------------------------------------------------------------------
def _score_pair(seed, v, ties):
    """(approx, ref): with ``ties`` both draw from a handful of values, so
    every ranking leans on the ascending-id tie-break."""
    rng = np.random.default_rng(seed)
    if ties:
        ref = rng.integers(0, 5, v).astype(np.float64)
        approx = ref + rng.integers(-1, 2, v)
    else:
        ref = rng.random(v)
        approx = ref + rng.normal(0, 0.05, v)
    return approx, ref


def _all_metrics(m, approx, ref, n):
    ro = m.ranking(ref)
    ao = m.ranking(approx)
    out = {"ranking": m.ranking(approx).tolist(),
           "topk": m.topk_indices(approx, n).tolist(),
           "mae": m.mae(approx, ref),
           "kendall": m.kendall_tau(approx, ref, n),
           "kendall_pre": m.kendall_tau(approx, ref, n, ref_order=ro),
           "report": m.full_report(approx, ref, ns=(min(n, 10), n))}
    for name in ("num_errors", "edit_distance", "ndcg", "precision_at"):
        fn = getattr(m, name)
        out[name] = fn(approx, ref, n)
        out[name + "_pre"] = fn(approx, ref, n, approx_order=ao, ref_order=ro)
    out["ndcg_all"] = m.ndcg(approx, ref)
    return out


@pytest.mark.parametrize("scipy_path", [True, False], ids=["scipy", "numpy"])
@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("seed,v,n", [(0, 60, 10), (1, 200, 50), (2, 40, 80),
                                      (3, 7, 20), (4, 1, 3)])
def test_metrics_equal_reference(monkeypatch, scipy_path, ties, seed, v, n):
    """Every metric, with and without precomputed orders, equals the
    reference's exactly; ``n`` above |V| is clamped alike.  Kendall runs
    through scipy and through the numpy fallback in both packages."""
    if not scipy_path:
        monkeypatch.setattr(rmet, "_scipy_kendalltau", None)
        monkeypatch.setattr(tmet, "_scipy_kendalltau", None)
    elif rmet._scipy_kendalltau is None or tmet._scipy_kendalltau is None:
        pytest.skip("scipy is not installed")
    approx, ref = _score_pair(seed, v, ties)
    want = _all_metrics(rmet, approx, ref, n)
    got = _all_metrics(tmet, approx, ref, n)
    assert got == want


def test_metrics_aggregate_equal_reference():
    reports = {"ref": [], "port": []}
    for seed in range(6):
        approx, ref = _score_pair(seed, 120, ties=seed % 2 == 0)
        reports["ref"].append(rmet.full_report(approx, ref))
        reports["port"].append(tmet.full_report(approx, ref))
    assert tmet.aggregate_reports(reports["port"]) == \
        rmet.aggregate_reports(reports["ref"])


def test_kendall_numpy_fallback_equals_scipy_value():
    """The fallback τ-b is the same statistic as scipy's (up to float
    rounding) on tied data, in the port as in the reference."""
    approx, ref = _score_pair(9, 80, ties=True)
    idx = tmet.ranking(ref)[:30]
    a = tmet._kendall_tau_b(ref[idx], approx[idx])
    assert a == rmet._kendall_tau_b(ref[idx], approx[idx])
    if tmet._scipy_kendalltau is not None:
        assert abs(a - tmet._scipy_kendalltau(ref[idx], approx[idx])[0]) < 1e-12


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=40),
       st.lists(st.integers(-2, 2), min_size=40, max_size=40),
       st.integers(1, 60))
def test_metrics_property_equal_reference(ref_vals, noise, n):
    """Small integer score vectors (ties everywhere, all-equal vectors,
    single vertices) and any cutoff: identical metrics."""
    ref = np.asarray(ref_vals, np.float64)
    approx = ref + np.asarray(noise[: ref.shape[0]], np.float64)
    assert _all_metrics(tmet, approx, ref, n) == _all_metrics(rmet, approx, ref, n)


# ---------------------------------------------------------------------------
# core.csr_compare
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gnp_1e5", "gnp_2e5", "ws_1e5", "ws_2e5",
                                  "pl_1e5", "pl_2e5", "amazon_like", "twitter_like"])
def test_format_comparison_equals_reference(name):
    g, tg = rsuite(scale=0.02)[name], tsuite(scale=0.02)[name]
    assert np.array_equal(g.x, tg.x) and np.array_equal(g.y, tg.y)
    assert tcsr.format_comparison(tg) == rcsr.format_comparison(g)
    assert tcsr.format_comparison(tg, gang=32) == rcsr.format_comparison(g, gang=32)


# ---------------------------------------------------------------------------
# quality estimator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,fraction", [(0, 0.25), (7, 0.5), (3, 0.9),
                                           (1, 0.0), (2, 1.0)])
def test_should_sample_draw_for_draw(seed, fraction):
    r = rauto.QualityEstimator(rauto.ShadowConfig(sample_fraction=fraction, seed=seed))
    t = tauto.QualityEstimator(tauto.ShadowConfig(sample_fraction=fraction, seed=seed))
    assert [t.should_sample() for _ in range(300)] == \
        [r.should_sample() for _ in range(300)]


@pytest.mark.parametrize("metric", ["ndcg", "precision"])
@pytest.mark.parametrize("k", [10, 50, 500])
def test_score_quality_equals_reference(metric, k):
    for seed in range(4):
        approx, ref = _score_pair(seed, 300, ties=seed % 2 == 0)
        want = rauto.score_quality(approx, ref, metric=metric, k=k)
        assert tauto.score_quality(approx, ref, metric=metric, k=k) == want
        ro = rmet.ranking(ref)
        assert tauto.score_quality(approx, ref, metric=metric, k=k, ref_order=ro) == want


def _estimator_trace(pkg, met):
    """The sequence of ``tests/test_autotune.py:32`` plus shadow
    observations and a decay, as the estimator's observable state."""
    est = pkg.QualityEstimator(pkg.ShadowConfig(window=4, min_samples=3))
    trace = []
    for s in (0.9, 1.0, 0.8, 1.0, 1.0, 1.0, 1.0):
        est.record("g", "Q1.25", s)
        trace.append((est.estimate("g", "Q1.25"), est.samples("g", "Q1.25")))
    for seed in range(5):
        approx, ref = _score_pair(seed, 120, ties=seed % 2 == 1)
        score = est.observe("g", "Q1.23", approx, ref,
                            ref_order=met.ranking(ref) if seed % 2 else None)
        trace.append((score, est.estimate("g", "Q1.23"), est.shadow_evaluations))
    trace.append(est.snapshot())
    est.decay_graph("g")
    trace.append((est.samples("g", "Q1.25"), est.samples("g", "Q1.23"), est.snapshot()))
    est.decay_graph("g", keep_fraction=0.0)
    trace.append((est.samples("g", "Q1.25"), est.estimate("g", "Q1.23")))
    est.record("h", "f32", 1.0)
    est.forget_graph("g")
    trace.append((est.estimate("g", "Q1.25"), est.samples("h", "f32"), est.snapshot()))
    return trace


def test_estimator_windows_equal_reference():
    assert _estimator_trace(tauto, tmet) == _estimator_trace(rauto, rmet)


# ---------------------------------------------------------------------------
# precision controller: ladder + hysteresis
# ---------------------------------------------------------------------------
def _state(ctl):
    return ({k: (s.rung, s.good, s.bad, s.promote_backoff, s.probing)
             for k, s in ctl._states.items()},
            ctl.promotions, ctl.demotions, ctl.summary(), ctl.target_ceiling)


def _ctl(pkg, window=1, **kw):
    cfg = pkg.AutotuneConfig(shadow=pkg.ShadowConfig(min_samples=1, window=window), **kw)
    return pkg.PrecisionController(cfg)


def _observe(ctl, steps, target):
    """Feed (fmt_key or None for the current rung, score) steps; record the
    resolved rung and the full state after each."""
    trace = []
    for key, score in steps:
        if key is None:
            key = ctl.rung_key("g", target)
        ctl.observe_quality("g", key, score, target=target)
        fmt = ctl.resolve("g", target)
        trace.append((None if fmt is None else fmt.name, _state(ctl)))
    return trace


# each scenario: (controller kwargs, target, steps); the steps of
# tests/test_autotune.py:73-176 (window 1: each observation is an estimate)
SCENARIOS = {
    "demote_after_patience": (dict(demote_patience=2), 0.95,
                              [("Q1.25", 0.5)] * 2),
    "promote_after_patience": (dict(promote_patience=3), 0.9, [("Q1.25", 1.0)] * 3),
    "alternating_no_thrash": (dict(promote_patience=2, demote_patience=2), 0.95,
                              [("Q1.25", 1.0 if i % 2 == 0 else 0.5) for i in range(20)]),
    "dead_band": (dict(promote_patience=2, demote_patience=2, promote_margin=0.02),
                  0.95, [("Q1.25", 0.955)] * 10),
    "stale_format": (dict(demote_patience=1), 0.95, [("Q1.19", 0.1)] * 5),
    "float_climbs_back": (dict(demote_patience=1, promote_patience=2), 0.95,
                          [("Q1.25", 0.2)] + [(FLOAT_KEY, 1.0)] * 2),
    "backoff_on_failing_probe": (dict(promote_patience=1, demote_patience=1), 0.95,
                                 ([("Q1.25", 1.0)] + [("Q1.23", 0.5)])
                                 + ([("Q1.25", 1.0)] * 2 + [("Q1.23", 0.5)])
                                 + ([("Q1.25", 1.0)] * 4 + [("Q1.23", 0.5)])
                                 + ([("Q1.25", 1.0)] * 8 + [("Q1.23", 0.5)])),
    "backoff_resets": (dict(promote_patience=1, demote_patience=1), 0.95,
                       [("Q1.25", 1.0), ("Q1.23", 0.5), ("Q1.25", 1.0), ("Q1.25", 1.0),
                        ("Q1.23", 1.0), ("Q1.23", 1.0)]),
    "walk_the_rung": (dict(promote_patience=1, demote_patience=1, ladder=(12, 16, 20)),
                      0.9, [(None, s) for s in (1.0, 1.0, 0.5, 0.95, 0.2, 0.2, 1.0,
                                                1.0, 1.0, 0.93, 0.89, 1.0)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_scenarios_equal_reference(name):
    kw, target, steps = SCENARIOS[name]
    want = _observe(_ctl(rauto, **kw), steps, target)
    got = _observe(_ctl(tauto, **kw), steps, target)
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_controller_random_walk_equal_reference(seed):
    """Seeded random observations (wider windows, several targets and
    formats, decays, a ceiling) leave both controllers in the same state
    after every step."""
    rng = np.random.default_rng(seed)
    kw = dict(window=3, promote_patience=2, demote_patience=2, ladder=(16, 20, 24))
    ctls = (_ctl(rauto, **kw), _ctl(tauto, **kw))
    targets = (None, 0.9, 0.97)
    for _ in range(150):
        target = targets[rng.integers(0, 3)]
        op = int(rng.integers(0, 20))
        score = float(rng.uniform(0.85, 1.0))
        for ctl in ctls:
            if op == 0:
                ctl.decay_graph("g", keep_fraction=0.5)
            elif op == 1:
                ctl.set_target_ceiling(0.92 if ctl.target_ceiling is None else None)
            else:
                key = ctl.rung_key("g", target) if op < 17 else "Q1.15"
                ctl.observe_quality("g", key, score, target=target)
        assert _state(ctls[1]) == _state(ctls[0])


def test_controller_shadow_and_lifecycle_equal_reference():
    """``observe_shadow`` on score vectors, ``decay_graph`` (rungs and
    backoff survive, streaks reset), ``forget_graph`` and the validation
    errors."""
    out = []
    for pkg, met in ((rauto, rmet), (tauto, tmet)):
        ctl = _ctl(pkg, window=4, promote_patience=2, demote_patience=2)
        trace = []
        for seed in range(8):
            approx, ref = _score_pair(seed, 150, ties=False)
            if seed >= 4:
                approx = ref + np.random.default_rng(seed).normal(0, 0.3, 150)
            key = ctl.rung_key("g", 0.95)
            trace.append(ctl.observe_shadow("g", key, approx, ref, target=0.95,
                                            ref_order=met.ranking(ref)))
            trace.append(_state(ctl))
        ctl.decay_graph("g")
        trace.append((_state(ctl), ctl.estimator.samples("g", ctl.rung_key("g", 0.95))))
        ctl.forget_graph("g")
        trace.append(_state(ctl))
        errors = []
        for bad in (lambda: ctl.resolve("g", 0.0), lambda: ctl.resolve("g", 1.5),
                    lambda: pkg.AutotuneConfig(ladder=()),
                    lambda: pkg.AutotuneConfig(ladder=(26, 20)),
                    lambda: pkg.AutotuneConfig(promote_patience=0),
                    lambda: ctl.set_target_ceiling(0.0),
                    lambda: ctl.estimator.decay_graph("g", 2.0),
                    lambda: pkg.ShadowConfig(metric="mrr")):
            with pytest.raises(ValueError) as e:
                bad()
            errors.append(str(e.value))
        trace.append(errors)
        out.append(trace)
    assert out[1] == out[0]
    assert tctl_mod.DEFAULT_LADDER == rctl_mod.DEFAULT_LADDER
    assert tctl_mod.FLOAT_RUNG == rctl_mod.FLOAT_RUNG == FLOAT_KEY
    assert sorted(set(rauto.__all__) - set(tauto.__all__)) == []


# ---------------------------------------------------------------------------
# prefetcher
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _prefetch_trace(mod, half_life):
    clock = _Clock()
    pf = mod.Prefetcher(mod.PrefetchConfig(top_n=3, max_per_pump=4, min_count=2,
                                           half_life_s=half_life), time_fn=clock)
    counts = {v: float(c) for v, c in enumerate([5, 1, 3, 3, 0, 7, 2, 2, 9])}
    last = {v: (10, "Q1.25") for v in counts}
    trace = [pf.candidates("g", counts)]
    pf.note_invalidated("g", [4, 8, 4, 2, 6, 1])
    pf.note_invalidated("h", [3])
    trace += [pf.stats(), pf.candidates("g", counts, limit=3), pf.stats(),
              pf.candidates("g", counts), pf.stats()]
    for dt in (5.0, 0.0, 30.0, -10.0, 400.0):
        clock.t += dt
        pf.decay_demand("g", counts, last_seen=last)
        trace.append((dict(counts), sorted(last), pf.candidates("g", counts)))
    pf.drop_graph("h")
    trace.append(pf.stats())
    return trace


@pytest.mark.parametrize("half_life", [None, 10.0], ids=["cumulative", "decaying"])
def test_prefetcher_equal_reference(half_life):
    assert _prefetch_trace(tpre, half_life) == _prefetch_trace(rpre, half_life)
    for kw in (dict(top_n=0), dict(min_count=0), dict(half_life_s=0.0),
               dict(suppress_depth=0)):
        with pytest.raises(ValueError):
            tpre.PrefetchConfig(**kw)


# ---------------------------------------------------------------------------
# PPRService: precision="auto", shadow feedback, prefetch
# ---------------------------------------------------------------------------
def _services(g, ref_family, port_family, autotune=None, formats=(), **kw):
    r = RService(autotune=autotune(rauto) if autotune else None, **kw)
    r.register_graph("g", g, formats=list(formats), engine=ref_family)
    t = TService(autotune=autotune(tauto) if autotune else None, device=CPU, **kw)
    t.register_graph("g", _port(g), formats=list(formats), engine=port_family)
    return r, t


def _same_recs(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (a.query.vertex, a.query.k, a.source, a.precision) == \
            (b.query.vertex, b.query.k, b.source, b.precision)
        if a.precision == FLOAT_KEY:
            assert np.abs(a.scores - b.scores).max(initial=0.0) < 1e-6
        else:
            assert np.array_equal(a.vertices, b.vertices)
            assert np.array_equal(a.scores, b.scores)


_COUNTERS = ("autotune_", "prefetch_", "shadow_evaluations", "cache_", "lru_",
             "auto_", "served_", "waves", "queries_served")


def _same_telemetry(r, t):
    sr, st_ = r.telemetry_summary(), t.telemetry_summary()
    keys = sorted(k for k in sr if k.startswith(_COUNTERS)
                  and k != "shadow_quality_mean")
    assert keys == sorted(k for k in st_ if k.startswith(_COUNTERS)
                          and k != "shadow_quality_mean")
    assert {k: st_[k] for k in keys} == {k: sr[k] for k in keys}
    # sampling decisions: the same number of shadow scores, within 1e-6
    a, b = r.telemetry.shadow_scores, t.telemetry.shadow_scores
    assert len(a) == len(b)
    assert np.abs(np.asarray(a) - np.asarray(b)).max(initial=0.0) < 1e-6
    assert t.telemetry.auto_resolved == r.telemetry.auto_resolved
    assert t.controller.promotions == r.controller.promotions
    assert t.controller.demotions == r.controller.demotions


def _latency_count(svc) -> int:
    """Queries recorded in the query-latency histogram of graph "g"."""
    return svc.telemetry._query_latency.labels(graph="g").count


def _auto_cfg(pkg, **kw):
    shadow = kw.pop("shadow", dict(sample_fraction=1.0, min_samples=2, window=8))
    return pkg.AutotuneConfig(shadow=pkg.ShadowConfig(**shadow), **kw)


@pytest.mark.parametrize("families", FAMILIES, ids=lambda f: f[1])
def test_auto_serves_fixed_and_meets_target_like_reference(graph, families):
    r, t = _services(graph, *families, autotune=_auto_cfg, kappa=4, iterations=10)
    rng = np.random.default_rng(0)
    verts = rng.integers(0, graph.num_vertices, 16)
    want = r.run_batch([RQuery("g", int(v), k=10, precision="auto",
                               quality_target=0.95) for v in verts])
    got = t.run_batch([TQuery("g", int(v), k=10, precision="auto",
                              quality_target=0.95) for v in verts])
    _same_recs(want, got)
    assert all(rec.precision != FLOAT_KEY for rec in got)
    s = t.telemetry_summary()
    assert s["shadow_evaluations"] > 0 and s["shadow_quality_mean"] >= 0.95
    assert sum(v for k, v in s.items() if k.startswith("auto_")) == 16
    _same_telemetry(r, t)


@pytest.mark.parametrize("families", FAMILIES, ids=lambda f: f[1])
def test_auto_batches_with_explicit_traffic_like_reference(graph, families):
    r, t = _services(graph, *families, autotune=_auto_cfg, kappa=4, iterations=10)
    resolved = t.controller.resolve("g", None).name
    assert resolved == r.controller.resolve("g", None).name
    qs = [(1, "auto"), (2, resolved), (3, "auto"), (4, resolved)]
    want = r.run_batch([RQuery("g", v, precision=p) for v, p in qs])
    got = t.run_batch([TQuery("g", v, precision=p) for v, p in qs])
    _same_recs(want, got)
    assert t.telemetry.waves == r.telemetry.waves == 1
    _same_telemetry(r, t)


@pytest.mark.parametrize("families", FAMILIES, ids=lambda f: f[1])
def test_auto_ladder_walk_and_sampling_like_reference(families):
    """A narrow ladder (Q1.7–Q1.11) and a 0.99 target on an ER graph, so
    shadow scores fall below 1 and the ladder moves both ways; half the auto
    queries sampled from seed 3, mixed with explicit-precision and float
    traffic over several batches."""
    g = erdos_renyi(300, 1800, seed=3)

    def cfg(pkg):
        return _auto_cfg(pkg, ladder=(8, 10, 12), promote_patience=2,
                         demote_patience=2,
                         shadow=dict(sample_fraction=0.5, min_samples=2, window=4,
                                     seed=3))
    r, t = _services(g, *families, autotune=cfg, kappa=4, iterations=10,
                     formats=(12,))
    rng = np.random.default_rng(1)
    for _ in range(5):
        batch = [(int(v), "auto" if i % 3 else (None if i % 2 else 12))
                 for i, v in enumerate(rng.integers(0, g.num_vertices, 8))]
        want = r.run_batch([RQuery("g", v, precision=p, quality_target=0.99)
                            for v, p in batch])
        got = t.run_batch([TQuery("g", v, precision=p, quality_target=0.99)
                           for v, p in batch])
        _same_recs(want, got)
        _same_telemetry(r, t)
    assert t.controller.promotions > 0 and t.controller.demotions > 0
    assert min(t.telemetry.shadow_scores) < 0.99


@pytest.mark.parametrize("families", FAMILIES, ids=lambda f: f[1])
def test_auto_demotes_to_float_on_unreachable_target_like_reference(families):
    """``tests/test_autotune.py:354-377``: Q1.7 on an ER graph misses 0.95,
    the ladder walks up to the float32 rung and later queries are exact."""
    g = erdos_renyi(300, 1800, seed=3)

    def cfg(pkg):
        return _auto_cfg(pkg, ladder=(8,), demote_patience=1,
                         shadow=dict(sample_fraction=1.0, min_samples=1, window=2))
    r, t = _services(g, *families, autotune=cfg, kappa=2, iterations=10)
    for v in (5, 9, 11, 21, 33, 41):
        _same_recs(r.run_batch([RQuery("g", v, precision="auto", quality_target=0.95)]),
                   t.run_batch([TQuery("g", v, precision="auto", quality_target=0.95)]))
    assert t.controller.resolve("g", 0.95) is None
    assert t.controller.demotions >= 1
    served = t.telemetry.served_by_precision
    assert served == r.telemetry.served_by_precision
    assert FLOAT_KEY in served and served.get("Q1.7", 0) >= 1
    _same_telemetry(r, t)


def test_degrade_and_restore_quality_like_reference(graph):
    r, t = _services(graph, "single", "single", autotune=_auto_cfg, kappa=2,
                     iterations=6)
    for svc, query in ((r, RQuery), (t, TQuery)):
        svc.degrade_quality(0.9)
        svc.degrade_quality(0.9)                   # idempotent
        svc.run_batch([query("g", 3, precision="auto"),
                       query("g", 5, precision="auto", quality_target=0.85)])
        svc.restore_quality()
        svc.restore_quality()
        svc.run_batch([query("g", 7, precision="auto")])
    assert t.controller.target_ceiling is None
    assert t.controller._states.keys() == r.controller._states.keys()
    sr, st_ = r.telemetry_summary(), t.telemetry_summary()
    for k in sr:
        if k.startswith(("slo_", "queries_degraded", "auto_")):
            assert st_[k] == sr[k], k
    assert [e["kind"] for e in t.recorder.events()] == \
        [e["kind"] for e in r.recorder.events()]
    _same_telemetry(r, t)


def test_autotune_windows_decay_not_reset_on_delta(delta_graph):
    """``tests/test_graph_updates.py:262``: a delta halves the windows, a
    re-registration resets them, in both packages."""
    out = []
    for svc, delta, g in ((RService(kappa=2, iterations=3), REdgeDelta, delta_graph),
                          (TService(kappa=2, iterations=3, device=CPU), TEdgeDelta,
                           _port(delta_graph))):
        svc.register_graph("g", g)
        est = svc.controller.estimator
        for _ in range(8):
            est.record("g", "Q1.25", 0.97)
        svc.apply_delta("g", delta(add_src=[1], add_dst=[2]))
        after_delta = est.samples("g", "Q1.25")
        svc.register_graph("g", g)
        out.append((after_delta, est.samples("g", "Q1.25")))
    assert out[1] == out[0] == (4, 0)


def _prefetch_services(g, families, **cfg):
    r = RService(kappa=2, iterations=4, prefetch=rpre.PrefetchConfig(**cfg))
    r.register_graph("g", g, formats=[26, 20], engine=families[0])
    t = TService(kappa=2, iterations=4, prefetch=tpre.PrefetchConfig(**cfg), device=CPU)
    t.register_graph("g", _port(g), formats=[26, 20], engine=families[1])
    return r, t


def _both(r, t, fn):
    """Apply ``fn(svc, query_cls)`` to both services; compare the results."""
    want, got = fn(r, RQuery), fn(t, TQuery)
    if isinstance(want, list):
        _same_recs(want, got)
    else:
        assert got == want
    return got


@pytest.mark.parametrize("families", FAMILIES, ids=lambda f: f[1])
def test_prefetch_warms_hot_vertices_like_reference(delta_graph, families):
    """``tests/test_graph_updates.py:331``."""
    r, t = _prefetch_services(delta_graph, families, top_n=4, k=5, max_per_pump=4,
                              min_count=2)
    for _ in range(2):
        _both(r, t, lambda s, Q: s.run_batch([Q("g", 3, k=5, precision="auto"),
                                              Q("g", 7, k=5, precision="auto")]))
    before = t.telemetry_summary()["prefetch_issued"]
    _both(r, t, lambda s, Q: s.poll())
    for _ in range(2):
        _both(r, t, lambda s, Q: s.run_batch([Q("g", 11, k=5, precision="auto")]))
    for s in (r, t):
        s.cache.invalidate(lambda k: k[2] == 11)
    assert _both(r, t, lambda s, Q: s.poll()) == 1   # the prefetch wave
    assert t.telemetry_summary()["prefetch_issued"] > before
    hits0 = t.telemetry_summary()["lru_hits"]
    rec = _both(r, t, lambda s, Q: s.run_batch([Q("g", 11, k=5, precision="auto")]))[0]
    assert rec.source == "cache"
    assert t.telemetry_summary()["lru_hits"] == hits0 + 1
    _same_telemetry(r, t)
    # prefetch queries stay out of the latency reservoir
    assert _latency_count(t) == _latency_count(r)


@pytest.mark.parametrize("families", FAMILIES, ids=lambda f: f[1])
def test_prefetch_rewarms_after_delta_like_reference(delta_graph, families):
    """``tests/test_graph_updates.py:355`` and ``:371``: dropped hot
    vertices are re-warmed under their last real (k, precision) key."""
    r, t = _prefetch_services(delta_graph, families, top_n=2, k=10, max_per_pump=4,
                              min_count=2)
    for _ in range(3):
        _both(r, t, lambda s, Q: s.run_batch([Q("g", 3, k=5, precision="auto"),
                                              Q("g", 9, k=7, precision=20)]))
    reports = [s.apply_delta("g", d(add_src=[3, 9], add_dst=[200, 201]))
               for s, d in ((r, REdgeDelta), (t, TEdgeDelta))]
    for rep in reports:
        rep.pop("apply_s")
    assert reports[1] == reports[0] and reports[0]["cache_dropped"] >= 2
    assert t.telemetry_summary()["prefetch_rewarms_queued"] == 2
    _both(r, t, lambda s, Q: s.poll())
    recs = _both(r, t, lambda s, Q: s.run_batch([Q("g", 3, k=5, precision="auto"),
                                                 Q("g", 9, k=7, precision=20)]))
    assert [rec.source for rec in recs] == ["cache", "cache"]
    assert recs[1].precision == "Q1.19"
    _same_telemetry(r, t)


def test_prefetch_rewarm_queue_and_suppression_like_reference(delta_graph):
    """``tests/test_graph_updates.py:385``, plus an idle poll with κ queued
    being suppressed rather than prefetching."""
    r, t = _prefetch_services(delta_graph, ("single", "single"), top_n=2, k=5,
                              max_per_pump=2, min_count=1)
    hot = [3, 7, 11, 15]
    for v in hot:
        _both(r, t, lambda s, Q: s.run_batch([Q("g", v, k=5, precision="auto")]))
    for s in (r, t):
        s.prefetcher.note_invalidated("g", hot)
        s.cache.invalidate(lambda k: True)
    _both(r, t, lambda s, Q: s.poll())
    assert t.telemetry_summary()["prefetch_rewarms_pending"] == 2
    # two live queries on distinct streams: nothing launchable at κ=2, but the
    # queue is a wave deep, so the idle poll is suppressed
    for s, Q in ((r, RQuery), (t, TQuery)):
        s.submit(Q("g", 21, k=5, precision=26))
        s.submit(Q("g", 22, k=5, precision=20))
    assert _both(r, t, lambda s, Q: s.poll(now=-1.0)) == 0
    assert t.telemetry_summary()["prefetch_suppressed"] == 1
    _both(r, t, lambda s, Q: s.flush())
    _both(r, t, lambda s, Q: s.poll())
    assert t.telemetry_summary()["prefetch_rewarms_pending"] == 0
    for v in hot:
        _both(r, t, lambda s, Q: s.run_batch([Q("g", v, k=5, precision="auto")]))
    _same_telemetry(r, t)


def test_prefetch_query_submitted_directly_skips_latency(graph):
    """A ``PPRQuery(prefetch=True)`` is served like any query and kept out
    of the query-latency telemetry, as in the reference."""
    out = []
    for svc, Q in ((RService(kappa=1, iterations=3), RQuery),
                   (TService(kappa=1, iterations=3, device=CPU), TQuery)):
        svc.register_graph("g", graph if Q is RQuery else _port(graph))
        first = svc.run_batch([Q("g", 4, prefetch=True)])[0]
        again = svc.run_batch([Q("g", 4, prefetch=True)])[0]
        out.append((first.source, again.source, _latency_count(svc)))
    assert out[1] == out[0] == ("wave", "cache", 0)


def test_shadow_copies_only_sampled_columns(graph, monkeypatch):
    """The shadow path reads the served state's sampled columns only, and
    runs the float engine over exactly those columns for the full budget."""
    from repro_torch.ppr_serving.engine import fused as fused_mod

    t = TService(kappa=4, iterations=7, device=CPU,
                 autotune=_auto_cfg(tauto, shadow=dict(sample_fraction=0.5, seed=3,
                                                       min_samples=2, window=8)))
    t.register_graph("g", _port(graph), engine="fused")
    widths = []
    kernel = fused_mod.fused_ppr_iteration

    def spy(topo, val, dang, vmat, p, **kw):
        widths.append((p.dtype, int(p.shape[1])))
        return kernel(topo, val, dang, vmat, p, **kw)

    monkeypatch.setattr(fused_mod, "fused_ppr_iteration", spy)
    t.run_batch([TQuery("g", v, precision="auto") for v in (1, 2, 3, 4)])
    sampled = int(t.controller.estimator.shadow_evaluations)
    assert 0 < sampled < 4
    assert widths == [(torch.int32, 4)] * 7 + [(torch.float32, sampled)] * 7
