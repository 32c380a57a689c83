"""The in-process measurement of the timeline's cost (``timeline_cost``) at
the CPU's sizes: the loop's turns alternate off, on, on, off with one
timeline armed in the "on" turns alone and left disarmed, every turn's waves
are booked, and a span's cost is read both ways."""
import itertools

import pytest

from portbench import timeline_cost

torch = pytest.importorskip("torch")

from repro_torch.obs import trace  # noqa: E402


def _ticks():
    """A clock that moves one second a read: a turn reads it twice, so a
    run of ``s`` seconds makes ``s // 2`` turns whatever the host's speed."""
    ticks = itertools.count()
    return lambda: float(next(ticks))


def test_turns_alternate_and_every_turn_is_booked(tiny_cell, monkeypatch):
    svc, stream, query, outstanding = timeline_cost.build(
        tiny_cell("gnp_2e5.q25.saturate"), 2**31 + 5, "cpu")
    seen = []
    poll = svc.poll
    monkeypatch.setattr(svc, "poll", lambda: seen.append(trace.armed) or poll())
    got = timeline_cost.alternate(svc, stream, query, outstanding, seconds=16,
                                  chunks=2, clock=_ticks())
    assert trace.armed is None
    armed = [tl is not None for tl in seen]
    assert len(armed) == got["turns"] == 8
    assert armed == [t % 4 in (1, 2) for t in range(len(armed))]
    assert len({id(tl) for tl in seen if tl is not None}) == 1
    assert got["records"] > 0 and got["dropped"] == 0
    waves = svc.telemetry.stage_stats()["iterate"]["count"]
    assert 0 < got["on"]["waves"] + got["off"]["waves"] <= waves
    for key in ("iterate_ms", "wave_ms"):
        assert got["on"][key] > 0 and got["off"][key] > 0
        assert len(got[key + "_rel"]["chunks"]) == 2


def test_a_block_answers_every_query_it_sent(tiny_cell):
    svc, stream, query, outstanding = timeline_cost.build(
        tiny_cell("gnp_2e5.q25.saturate"), 7, "cpu")
    row = timeline_cost.serve_block(svc, stream, query, outstanding, waves=4)
    assert row["wave_ms"] > row["iterate_ms"] > 0
    assert svc.scheduler.queue_depth() == 0


def test_the_control_arms_nothing(tiny_cell, monkeypatch):
    svc, stream, query, outstanding = timeline_cost.build(
        tiny_cell("gnp_2e5.q25.saturate"), 11, "cpu")
    seen = []
    poll = svc.poll
    monkeypatch.setattr(svc, "poll", lambda: seen.append(trace.armed) or poll())
    got = timeline_cost.alternate(svc, stream, query, outstanding, seconds=8,
                                  chunks=1, arm=False, clock=_ticks())
    assert len(seen) == got["turns"] == 4 and all(tl is None for tl in seen)
    assert got["records"] == got["dropped"] == 0
    assert got["on"]["waves"] + got["off"]["waves"] > 0


@pytest.mark.parametrize("how", ["timeline", "record_function"])
def test_span_cost_is_read_both_ways(how):
    assert timeline_cost.span_cost_us(torch, 2_000, how) > 0
    assert trace.armed is None
