"""The fused family's dst stream, built straight from the COO arrays.

The served path (registration, ``prepare``, waves, ``apply_delta`` and the
refresh) builds the stream from the graph's (dst, src)-sorted edges and
never the packet-padded ``FusedLayout``: the stream must be array-equal to
the one derived from that layout, before and after deltas and vertex
growth, so that answers stay bit-equal; a service whose
``build_fused_layout`` raises still serves answers equal to the plain
reference (``portbench/reference.py``); and registration reports the
stream's build and upload seconds as ``register_stream_s``.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import graphgen, harness, verdict  # noqa: E402
from repro_torch.core.coo import COOGraph  # noqa: E402
from repro_torch.core.fixed_point import format_for_bits  # noqa: E402
from repro_torch.graph_updates import EdgeDelta  # noqa: E402
from repro_torch.kernels import fused_ppr  # noqa: E402
from repro_torch.kernels.dst_stream import build_dst_stream  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.ppr_serving import FusedRegisteredGraph, PPRQuery, PPRService  # noqa: E402
from repro_torch.ppr_serving import get_engine  # noqa: E402
from repro_torch.ppr_serving.engine import fused as fused_engine  # noqa: E402

CPU = "cpu"
STREAM_FIELDS = ("row_ptr", "col", "nz_rows", "slice_row")
Q25 = {"kind": "fixed_exact", "int_bits": 1, "frac_bits": 25,
       "limits": {"rank_mismatch": 0, "raw_gap_lsb": 0, "bad_lists": 0}}
F32 = {"kind": "float", "limits": {"score_gap": 1e-6, "rank_gap": 1e-6, "bad_lists": 0}}


def _edges(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "gnp":       # the frozen generator leaves the top ids dangling
        return graphgen.erdos_renyi(3000, 30000, rng) + (3000,)
    return graphgen.holme_kim_powerlaw(3000, 10, 0.1, rng) + (3000,)


def _assert_streams_equal(a, b):
    assert a.num_rows == b.num_rows and a.slice_edges == b.slice_edges
    for f in STREAM_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.val.view(np.uint32), b.val.view(np.uint32))


def _served_graph(g):
    """A fused graph prepared as registration prepares it (f32 and Q1.25)."""
    rg = FusedRegisteredGraph("g", g, device=CPU)
    get_engine("fused_float").prepare(rg)
    get_engine("fused_fixed").prepare(rg, format_for_bits(26))
    return rg


def _delta(g, rng, n_add=64, n_remove=32, grow=0):
    rem = rng.choice(g.num_edges, n_remove, replace=False)
    nv = g.num_vertices + grow
    return EdgeDelta(add_src=rng.integers(0, nv, n_add), add_dst=rng.integers(0, nv, n_add),
                     remove_src=g.y[rem], remove_dst=g.x[rem],
                     new_num_vertices=nv if grow else None)


@pytest.mark.parametrize("case", ["gnp_dangling", "pl_hubs_empty_rows", "after_delta",
                                  "after_growth_across_a_block"])
def test_coo_stream_equals_the_layout_stream(case):
    kind = "pl" if case.startswith("pl") else "gnp"
    src, dst, nv = _edges(kind, seed=5)
    g = COOGraph.from_edges(src, dst, nv)
    if kind == "gnp":
        assert g.dangling[-100:].all()
    else:
        counts = np.bincount(g.x, minlength=nv)
        assert (counts == 0).any() and counts.max() > 20 * counts.mean()
    rg = _served_graph(g)
    if case.startswith("after"):
        grow = 600 if case == "after_growth_across_a_block" else 0
        rg.apply_delta(_delta(g, np.random.default_rng(6), grow=grow))
        get_engine("fused_fixed").on_delta(rg, None)
        assert rg.epoch == 1 and rg.last_refresh_blocks == 0
        assert rg.num_vertices == nv + grow
    want = build_dst_stream(fused_ppr.build_fused_layout(rg.source, rg.v_tile, rg.packet))
    _assert_streams_equal(rg.fused_stream(), want)
    topo = rg.fused_topology()
    for f in STREAM_FIELDS:
        assert torch.equal(getattr(topo, f), torch.as_tensor(getattr(want, f))), f
    assert rg._fused_layout is None          # the served path built no layout


def _judge(check, answers, edges):
    numbers = verdict.judge(check, lambda j: edges[j], answers, CPU, alpha=0.85,
                            iterations=10)
    assert numbers.pop("checked") == answers["ids"].shape[0]
    return numbers


def _answers(svc, verts, precision, version, k=10):
    recs = svc.run_batch([PPRQuery("g", int(v), k=k, precision=precision) for v in verts])
    return {"vertex": np.asarray(verts), "version": np.full(len(verts), version),
            "ids": np.stack([r.vertices for r in recs]).astype(np.int64),
            "scores": np.stack([np.asarray(r.scores, np.float64) for r in recs])}


def test_fused_service_serves_and_refreshes_without_the_layout(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the served path built the padded FusedLayout")

    monkeypatch.setattr(fused_engine, "build_fused_layout", refuse)
    monkeypatch.setattr(fused_ppr, "build_fused_layout", refuse)
    rng = np.random.default_rng(11)
    nv = 2048
    src, dst = graphgen.erdos_renyi(nv, 16 * nv, rng)
    svc = PPRService(kappa=8, iterations=10, cache_capacity=0, device=CPU)
    rg = svc.register_graph("g", COOGraph.from_edges(src, dst, nv), formats=[26],
                            engine="fused")
    edges = {0: (src, dst, nv)}
    verts = rng.choice(nv, 16, replace=False)
    for precision, check in ((26, Q25), (None, F32)):
        numbers = _judge(check, _answers(svc, verts, precision, 0), edges)
        assert all(numbers[m] <= check["limits"][m] for m in numbers), numbers
    rem = rng.choice(src.shape[0], 64, replace=False)
    add_src, add_dst = rng.integers(0, nv, 128), rng.integers(0, nv, 128)
    svc.apply_delta("g", EdgeDelta(add_src=add_src, add_dst=add_dst,
                                   remove_src=src[rem], remove_dst=dst[rem]))
    keep = np.ones(src.shape[0], bool)
    keep[rem] = False
    edges[1] = (np.concatenate([src[keep], add_src]),
                np.concatenate([dst[keep], add_dst]), nv)
    assert rg.epoch == 1 and rg._fused_layout is None
    for precision, check in ((26, Q25), (None, F32)):
        numbers = _judge(check, _answers(svc, verts, precision, 1), edges)
        assert all(numbers[m] <= check["limits"][m] for m in numbers), numbers
    assert set(rg.delta_timings) >= {"stream", "upload"}


def test_register_stream_s_survives_a_telemetry_reset_and_its_reader():
    read = harness.load_reader("stream_build_ms.register")
    assert read(SimpleNamespace(telemetry={"waves": 0})) is None
    assert read(SimpleNamespace(telemetry={"register_stream_s": 0.25})) == 250.0
    src, dst, nv = _edges("gnp", seed=2)
    single = PPRService(kappa=4, iterations=3, device=CPU)
    single.register_graph("g", COOGraph.from_edges(src, dst, nv))
    assert "register_stream_s" not in single.telemetry_summary()

    tl = trace.arm_timeline(64)
    try:
        svc = PPRService(kappa=4, iterations=3, device=CPU)
        rg = svc.register_graph("g", COOGraph.from_edges(src, dst, nv), formats=[26],
                                engine="fused")
    finally:
        trace.disarm_timeline()
    assert tl.stats()["ppr.graph.stream"]["count"] == 1
    t = rg.register_timings
    assert set(t) == {"stream", "upload"} and t["stream"] > 0 and t["upload"] > 0
    s = svc.telemetry_summary()["register_stream_s"]
    assert s == pytest.approx(t["stream"] + t["upload"]) and s > 0
    svc.run_batch([PPRQuery("g", v, k=5, precision=26) for v in range(4)])
    svc.telemetry.reset()
    assert svc.telemetry_summary()["register_stream_s"] == s
    svc.apply_delta("g", _delta(rg.source, np.random.default_rng(3)))
    assert svc.telemetry_summary()["register_stream_s"] == s
    assert read(SimpleNamespace(telemetry=svc.telemetry_summary())) == s * 1e3
