"""The program's spans on the device trace (``progtrace``): idle gaps named
by the innermost program span, device operations attributed to the span
they were launched in by correlation id, the stream-order fallback, and the
four readers, on synthetic events; and the port's timeline recorded through
the harness's window at the CPU's sizes."""
from types import SimpleNamespace

import pytest

from portbench import harness, progtrace

pytest.importorskip("torch")

from repro_torch.obs import trace  # noqa: E402

OFF = 1_000          # profiler clock − host clock, ns


def _timeline(rows):
    tl = trace.Timeline(64)
    for name, a, b, *wave in rows:       # in recording order (a span at its end)
        tl.record(trace.span_id(name), a, b, *wave)
    return tl


def _one_wave():
    """Host ns: a poll [0, 2000] that runs wave 1 [100, 1900]: plan, iterate
    with two steps, top-K, the device wait, resolve, callbacks; then a
    submit [2100, 2200] outside the poll."""
    return _timeline([
        ("ppr.admit", 50, 90),
        ("ppr.wave.plan", 110, 190, 1),
        ("ppr.step", 210, 300),
        ("ppr.step", 310, 400),
        ("ppr.wave.iterate", 200, 500, 1),
        ("ppr.wave.topk", 510, 600, 1),
        ("ppr.wave.device_wait", 600, 1600, 1),
        ("ppr.wave.resolve", 1600, 1700, 1),
        ("ppr.wave.callbacks", 1700, 1890, 1),
        ("ppr.wave", 100, 1900, 1),
        ("ppr.submit", 2100, 2200),
    ])


HARNESS = [(0, 2000, "portbench.poll"), (2050, 2300, "portbench.submit")]
# (device start, end, name, correlation id) on the profiler clock, and the
# launches (runtime calls) by correlation id
OPS = [(OFF + 250, OFF + 350, "spmv_dangling_kernel", 1),
       (OFF + 350, OFF + 420, "combine_kernel", 2),
       (OFF + 420, OFF + 480, "spmv_dangling_kernel", 3),
       (OFF + 480, OFF + 560, "combine_kernel", 4),
       (OFF + 560, OFF + 900, "DeviceRadixSortOnesweepKernel", 5),
       (OFF + 900, OFF + 950, "Memcpy DtoH (Device -> Pageable)", 6),
       (OFF + 950, OFF + 980, "Memcpy DtoH (Device -> Pageable)", 7),
       (OFF + 2150, OFF + 2160, "elementwise_kernel", 8)]
LAUNCH = {1: OFF + 220, 2: OFF + 230, 3: OFF + 320, 4: OFF + 330,
          5: OFF + 520, 6: OFF + 610, 7: OFF + 900, 8: OFF + 2120}


def _calls(launch):
    """The runtime calls of ``launch`` (5 ns each; the copies to pageable
    memory block until their copy ends), a synchronizing call inside top-K
    and one outside every program span."""
    calls = [(a, a + 5, "cudaLaunchKernel", c) for c, a in launch.items()]
    calls += [(OFF + 590, OFF + 595, "cudaStreamSynchronize", 0),
              (OFF + 2030, OFF + 2040, "cudaDeviceSynchronize", 0)]
    if launch:
        calls[5:7] = [(OFF + 610, OFF + 950, "cudaMemcpyAsync", 6),
                      (OFF + 900, OFF + 980, "cudaMemcpyAsync", 7)]
    return calls


def _summary(launch=LAUNCH, iterations=2):
    return progtrace.summarize(_one_wave(), OPS, _calls(launch), OFF, OFF, OFF + 2300,
                               HARNESS, iterations)


def test_gaps_are_named_by_the_innermost_program_span_under_the_harness_call():
    got = _summary()
    # the gaps: [0, 250) host, [980, 2150), [2160, 2300)
    assert got["idle_gaps"] == [
        ["portbench.poll/ppr.wave.device_wait", 1170e-9],
        ["portbench.poll/ppr.wave.plan", 250e-9],
        ["portbench.submit", 140e-9]]
    tl = got["timeline"]
    assert tl["device_wait_gap_max_us"] == pytest.approx(1.17)
    assert tl["device_wait_gaps_over_50us"] == 0


def test_runtime_call_seconds_are_booked_to_the_span_that_made_them():
    got = dict(_summary()["timeline"]["runtime_s_by_span"])
    assert got == pytest.approx({
        "ppr.wave.device_wait cudaMemcpyAsync": 420e-9,
        "ppr.step cudaLaunchKernel": 20e-9,
        "ppr.wave.topk cudaLaunchKernel": 5e-9,
        "ppr.wave.topk cudaStreamSynchronize": 5e-9,
        "ppr.submit cudaLaunchKernel": 5e-9,
        "- cudaDeviceSynchronize": 10e-9})


def test_the_host_blocks_in_synchronizing_calls_and_pageable_copies_only():
    tl = _summary()["timeline"]
    assert tl["blocked_s_by_span"] == pytest.approx({
        "ppr.wave.device_wait": 420e-9, "ppr.wave.topk": 5e-9, "-": 10e-9})
    assert tl["blocked_s"] == pytest.approx(425e-9)         # in program spans


@pytest.mark.parametrize("call, op, want", [
    ("cudaStreamSynchronize", None, True),
    ("cudaDeviceSynchronize", None, True),
    ("cudaEventSynchronize", None, True),
    ("cudaMemcpy", "Memcpy DtoD (Device -> Device)", True),
    ("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)", True),
    ("cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)", True),
    ("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pinned)", False),
    ("cudaMemcpyAsync", "Memcpy DtoD (Device -> Device)", False),
    ("cudaMemcpyAsync", None, False),
    ("cudaMemsetAsync", "Memset (Device)", False),
    ("cudaLaunchKernel", "elementwise_kernel", False),
    ("cudaStreamWaitEvent", None, False),
])
def test_which_runtime_calls_block(call, op, want):
    assert progtrace.blocks(call, op) is want


def test_operations_are_attributed_to_the_span_open_at_their_launch():
    tl = _summary()["timeline"]
    assert tl["attribution"] == "launch" and tl["launch_matched"] == 1.0
    dev = {n: s["device_s"] for n, s in tl["spans"].items()}
    assert dev["ppr.step"] == pytest.approx((100 + 70 + 60 + 80) * 1e-9)
    assert dev["ppr.wave.topk"] == pytest.approx(340e-9)
    assert dev["ppr.wave.device_wait"] == pytest.approx(80e-9)
    assert dev["ppr.submit"] == pytest.approx(10e-9)
    assert tl["topk_device_s"] == pytest.approx(340e-9)
    assert tl["attributed_share"] == pytest.approx(1.0)
    assert tl["launch_after_start"] == {"ops": 0, "over_10us": 0, "max_us": 0.0, "names": []}
    assert tl["copies_to_host_by_span"] == {"ppr.wave.device_wait": 2}
    assert tl["waves"] == 1 and tl["waves_steps_over_iterate"] == 0
    assert tl["iterates_without_all_steps"] == 0
    assert tl["spans"]["ppr.wave"]["self_s"] == pytest.approx(
        (1800 - 80 - 300 - 90 - 1000 - 100 - 190) * 1e-9)


def test_an_operation_launched_outside_every_span_is_unattributed():
    launch = {**LAUNCH, 8: OFF + 2020}                 # between the calls
    tl = _summary(launch)["timeline"]
    assert tl["attributed_share"] == pytest.approx(1 - 10 / 740)
    assert tl["spans"]["ppr.submit"]["device_s"] == 0.0


def test_a_launch_a_little_after_its_operation_still_attributes_it():
    """The device's and the host's timestamps disagree by microseconds: a
    call that seems to start just after its operation is still its launch,
    and the lag is counted."""
    tl = _summary({**LAUNCH, 5: OFF + 590})["timeline"]
    assert tl["launch_after_start"] == {
        "ops": 1, "over_10us": 0, "max_us": pytest.approx(0.03),
        "names": [("DeviceRadixSortOnesweepKernel", 1)]}
    assert tl["topk_device_s"] == pytest.approx(340e-9)
    assert tl["launch_matched"] == 1.0


def test_a_call_far_after_its_operation_is_no_launch():
    late = OFF + 560 + progtrace.LAUNCH_SLACK_NS + 1
    tl = _summary({**LAUNCH, 5: late})["timeline"]
    assert tl["launch_after_start"]["ops"] == 0
    assert tl["topk_device_s"] == 0.0
    assert tl["launch_matched"] == pytest.approx(7 / 8)
    assert tl["attributed_share"] == pytest.approx(1 - 340 / 740)


def test_without_runtime_calls_top_k_is_found_in_stream_order():
    tl = _summary(launch={})["timeline"]
    assert tl["attribution"] == "stream_order"
    assert tl["attributed_share"] is None and tl["launch_matched"] == 0.0
    # after the last combine_kernel: the sort and both copies
    assert tl["topk_device_s"] == pytest.approx((340 + 50 + 30) * 1e-9)


@pytest.mark.parametrize("names, want", [
    (["spmv_dangling_kernel", "combine_kernel", "sort", "Memcpy_DtoH", "Memcpy_DtoH",
      "fill"], [False, False, True, True, True, False]),
    # a memset between iterations is not top-K's; nor is a wave without copies
    (["combine_kernel", "Memset", "spmv_dangling_kernel", "combine_kernel", "gather",
      "Memcpy_DtoH", "spmv_dangling_kernel", "combine_kernel", "sort"],
     [False, False, False, False, True, True, False, False, False]),
    ([], []),
])
def test_stream_order_topk(names, want):
    assert progtrace.stream_order_topk(names) == want


def test_the_readers_on_a_hand_built_run():
    run = SimpleNamespace(device=_summary())
    got = {name: read(run) for name, read in progtrace.READERS.items()}
    assert got["topk_device_ms.saturate"] == pytest.approx(340e-6)
    assert got["step_host_us.saturate"] == pytest.approx(0.09)
    assert got["device_wait_ms.saturate"] == pytest.approx(425e-6)
    assert got["submit_host_us.saturate"] == pytest.approx(0.1)
    assert [m["name"] for m in progtrace.METRICS] == list(progtrace.READERS)


@pytest.mark.parametrize("device", [None, {"busy_s": 1.0, "window_s": 2.0},
                                    {"timeline": {"waves": 0, "spans": {},
                                                  "topk_device_s": 0.0}}])
def test_the_readers_read_nothing_without_spans(device):
    run = SimpleNamespace(device=device)
    assert all(read(run) is None for read in progtrace.READERS.values())


def test_the_new_metrics_fit_the_benchmark_contract():
    import json
    import re

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    taken = {m["name"] for m in bench["per_layer"] + bench["end_to_end"]}
    for m in progtrace.METRICS:
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", m["name"])
        assert m["name"] not in taken and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span")
        assert m["layer"] in layers | {"service: ppr_serving/service.py"}


def test_the_timeline_records_the_window_of_a_cpu_run(tiny_cell):
    cell = tiny_cell("gnp_2e5.q25.saturate")
    tl = trace.arm_timeline(1 << 18)
    try:
        result = harness.run_cell(cell, 2**31 + 11, 0.4, False, device="cpu")
    finally:
        assert trace.disarm_timeline() is tl
    assert result["correct"] is True, result["checks"]
    assert tl.dropped == 0
    st = tl.stats()
    waves = st["ppr.wave"]["count"]
    assert waves > 0 and st["ppr.step"]["count"] == 10 * waves
    assert st["ppr.submit"]["count"] == result["attempted"] + 2 * 16 + 8   # + warm-up
    for stage in ("plan", "iterate", "topk", "device_wait", "resolve", "callbacks"):
        assert st[f"ppr.wave.{stage}"]["count"] == waves
