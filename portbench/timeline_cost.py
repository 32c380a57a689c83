"""What arming the port's span timeline costs a traced run, measured inside
one process, where the host's drift from run to run cannot hide it.

    python3 portbench/timeline_cost.py --workload <cell> --seed <n>

Builds the cell's graph and service as the harness does and warms them,
starts the profiler as a traced run does (``devtrace``: device activity
only), then runs the harness's closed loop over the cell's vertices for
``SECONDS`` with the timeline armed in the middle pair of every four
turns of the loop (``alternate``; first as long with nothing armed, the
control), and reads from the service's telemetry
the mean host ms of the ``iterate`` stage (what ``iterate_host_ms`` reads)
and the wall ms a wave, on and off.

Then, for the choice between the timeline and ``torch.profiler``'s
``record_function`` ranges, it times one span of each on this host, with the
profiler off, recording device activity only, and recording the host's
operators too, and counts the ranges a device-only profile keeps; and it
serves blocks alternately under the two profilers, since ranges are kept only
where the host's operators are recorded (blocks of ``WAVES`` waves, off,
on, on, off ...).  Prints one JSON line.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import arrivals, graphgen  # noqa: E402

SECONDS = 30.0      # each of the two alternating runs: ~2,500 turns of ~4 waves
WAVES = 200         # a block under one profiler
SPANS = 100_000     # spans a hot-loop timing averages over


def build(cell, seed: int, device: str):
    """The cell's service on ``device``, warmed as the harness warms it, and
    its stream of query vertices."""
    from repro_torch.core.coo import COOGraph
    from repro_torch.ppr_serving import PPRQuery, PPRService

    gspec, sspec, tr = cell.config["graph"], cell.config["service"], cell.traffic
    nv, kappa = int(gspec["num_vertices"]), int(sspec["kappa"])
    src, dst = graphgen.make_graph(gspec, arrivals.rng_for(seed, "graph"))
    svc = PPRService(kappa=kappa, iterations=int(sspec["iterations"]),
                     alpha=float(sspec["alpha"]), max_wait=float(tr["max_wait_s"]),
                     cache_capacity=int(tr["cache_capacity"]), device=device)
    svc.register_graph("g", COOGraph.from_edges(src, dst, nv),
                       formats=sspec["formats"], engine=sspec["engine"])
    stream = arrivals.VertexStream(tr["vertices"], nv, seed)
    query = lambda v: PPRQuery("g", int(v), k=int(tr["k"]), precision=tr["precision"])
    svc.run_batch([query(stream.next()) for _ in range(2 * kappa + kappa // 2)])
    if tr.get("cache_warm_queries"):
        svc.run_batch([query(v) for v in stream.draw(int(tr["cache_warm_queries"]))])
    outstanding = kappa * int(tr["loop"].get("outstanding_per_kappa", 4))
    return svc, stream, query, outstanding


def serve_block(svc, stream, query, outstanding: int, waves: int) -> Dict[str, float]:
    """The closed loop until ``waves`` waves' worth of queries are answered;
    the block's mean ``iterate`` stage and wall time a wave, in ms."""
    svc.telemetry.reset()
    done = [0]
    sent = 0

    def answered(_fut):
        done[0] += 1

    target = waves * svc.kappa
    t0 = time.perf_counter()
    while done[0] < target:
        while sent - done[0] < outstanding:
            svc.submit(query(stream.next())).add_done_callback(answered)
            sent += 1
        svc.poll()
    svc.flush()
    wall = time.perf_counter() - t0
    st = svc.telemetry.stage_stats()["iterate"]
    return {"iterate_ms": st["mean_s"] * 1e3, "wave_ms": wall * 1e3 / st["count"]}


def alternate(svc, stream, query, outstanding: int, seconds: float,
              chunks: int = 16, capacity: int = 1 << 21, arm: bool = True,
              clock: Callable[[], float] = time.perf_counter) -> Dict:
    """The closed loop for ``seconds``, one timeline armed in the middle
    pair of every four turns (a turn tops the loop up and polls once: ~4
    waves), so that the host's drift, which moves a block of a second by
    ±10%, falls alike on both sides.  Per side: waves, the mean ``iterate``
    stage and wall ms a wave; and on − off over ``chunks`` consecutive
    stretches of the run, whose spread says what the difference can
    resolve.  ``arm=False`` arms nothing on either side: the control, whose
    difference is the method's own.  ``clock`` times the turns (seconds)."""
    from repro_torch.obs import trace

    tl = trace.Timeline(capacity) if arm else None
    svc.telemetry.reset()
    done = [0]
    sent, turn, prev = 0, 0, (0, 0.0)
    rows: List[tuple] = []          # (on, waves, iterate s, wall s) a turn

    def answered(_fut):
        done[0] += 1

    t_stop = clock() + seconds
    try:
        while True:
            t0 = clock()
            if t0 >= t_stop:
                break
            on = turn % 4 in (1, 2)
            trace.armed = tl if on else None
            while sent - done[0] < outstanding:
                svc.submit(query(stream.next())).add_done_callback(answered)
                sent += 1
            svc.poll()
            trace.armed = None
            t1 = clock()
            st = svc.telemetry.stage_stats().get("iterate")
            now = (st["count"], st["total_s"]) if st else (0, 0.0)
            rows.append((on, now[0] - prev[0], now[1] - prev[1], t1 - t0))
            prev, turn = now, turn + 1
    finally:
        trace.armed = None
    svc.flush()

    def side(part, on):
        waves = sum(r[1] for r in part if r[0] == on)
        return (waves, 1e3 * sum(r[2] for r in part if r[0] == on) / max(waves, 1),
                1e3 * sum(r[3] for r in part if r[0] == on) / max(waves, 1))

    out: Dict = {"turns": len(rows), "records": tl.n if arm else 0,
                 "dropped": tl.dropped if arm else 0}
    for on, name in ((True, "on"), (False, "off")):
        out[name] = dict(zip(("waves", "iterate_ms", "wave_ms"), side(rows, on)))
    n = len(rows) // chunks
    for j, key in ((1, "iterate_ms"), (2, "wave_ms")):
        diffs = []
        for c in range(chunks if n >= 4 else 0):
            part = rows[c * n:(c + 1) * n]
            on, off = side(part, True)[j], side(part, False)[j]
            diffs.append((on - off) / off if off else 0.0)
        q = statistics.quantiles(diffs, n=4) if len(diffs) > 1 else [None] * 3
        out[key + "_rel"] = {"all": (out["on"][key] / out["off"][key] - 1
                                     if out["off"][key] else None),
                             "chunks_q1_median_q3": q, "chunks": diffs}
    return out


def span_cost_us(torch, n: int, how: str) -> float:
    """Host µs of one span: ``timeline`` (two perf-counter reads and a
    record into an armed timeline) or ``record_function`` (a profiler range
    entered and left), less the empty loop's cost."""
    from repro_torch.obs import trace

    ns = time.perf_counter_ns
    if how == "timeline":
        tl = trace.Timeline(n)
        step = trace.span_id("ppr.step")
        t0 = ns()
        for _ in range(n):
            a = ns()
            tl.record(step, a, ns(), 1)
        spent = ns() - t0
    else:
        rf = torch.profiler.record_function
        t0 = ns()
        for _ in range(n):
            with rf("ppr.step"):
                pass
        spent = ns() - t0
    t0 = ns()
    for _ in range(n):
        pass
    return (spent - (ns() - t0)) / n / 1e3


def profiler(torch, host_ops: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    return profile(activities=acts)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from portbench import harness

    import torch
    if not torch.cuda.is_available():
        print("timeline_cost: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    svc, stream, query, outstanding = build(cell, args.seed, "cuda")
    out: Dict = {"workload": args.workload, "seed": args.seed,
                 "device": torch.cuda.get_device_name(0)}

    # the timeline under a traced run's profiler, turn by turn, after the
    # control that arms nothing
    prof = profiler(torch, host_ops=False)
    prof.start()
    serve_block(svc, stream, query, outstanding, WAVES)        # settle
    out["control_off_off"] = alternate(svc, stream, query, outstanding, SECONDS,
                                       arm=False)
    out["timeline_on_off"] = alternate(svc, stream, query, outstanding, SECONDS)
    torch.cuda.synchronize()
    prof.stop()
    del prof

    # one span, each way, under each profiler state
    cost: Dict[str, Dict[str, float]] = {}
    for state in ("off", "device", "device+host"):
        prof = None if state == "off" else profiler(torch, state == "device+host")
        if prof is not None:
            prof.start()
        cost[state] = {how: span_cost_us(torch, SPANS, how)
                       for how in ("timeline", "record_function")}
        if prof is not None:
            prof.stop()
    out["span_cost_us"] = cost
    prof = profiler(torch, host_ops=False)
    prof.start()
    for _ in range(100):
        with torch.profiler.record_function("ppr.step"):
            torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.stop()
    out["ranges_kept_by_device_only_profile"] = sum(
        e.name() == "ppr.step" for e in prof.profiler.kineto_results.events())

    # what a range-based design would need on the traced path: the host's
    # operators recorded, against a traced run's device-only profile
    rows = []
    for b in range(8):
        host_ops = b % 4 in (1, 2)
        prof = profiler(torch, host_ops)
        prof.start()
        row = serve_block(svc, stream, query, outstanding, WAVES)
        torch.cuda.synchronize()
        prof.stop()
        del prof
        rows.append(dict(row, host_ops=host_ops))
    out["host_ops_on_off"] = {
        key: {"on_median": statistics.median(r[key] for r in rows if r["host_ops"]),
              "off_median": statistics.median(r[key] for r in rows if not r["host_ops"])}
        for key in ("iterate_ms", "wave_ms")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
