"""The program's own spans on the device trace.

The port records a host timeline of its serving path when one is armed
(``repro_torch.obs.trace.Timeline``: submit, admission, each wave's stages,
each fused step), on ``time.perf_counter_ns``, the clock ``devtrace`` ties
the profiler to.  ``TimelineTrace`` is a
``devtrace.DeviceTrace`` that arms that timeline for the window it traces
and reads it beside the device events:

- each idle gap is named ``<harness call>/<innermost program span>`` at
  the gap's middle (the harness call alone where no program span covers it);
- each device operation is attributed to the innermost program span open at
  its launch: the CUDA runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) that Kineto records beside it under the same
  correlation id, put on the host clock by the marker.  Where the trace holds
  no runtime calls, top-K's operations are found in stream order instead
  (``stream_order_topk``) and nothing else is attributed;
- per span name: count, host seconds, self seconds, device seconds;
- the host seconds spent blocked on the device: the runtime calls that return
  only once the stream has caught up (``blocks``), wherever the program makes
  them (the results' copies, top-K's torch calls, ``plan``'s upload).

The summary is ``DeviceTrace.summary``'s with ``idle_gaps`` renamed and a
``timeline`` entry added, so a harness that builds its tracer from this
class passes everything on to its readers as ``run.device``.  The readers
of the four metrics this adds are ``READERS``; ``METRICS`` are their
``BENCHMARK.json`` entries.

Until the harness builds its tracer from this class, run a cell's traced
window with it as ``run.py --trace 1`` would, with the four metrics and
``info["timeline"]`` added to the result line::

    python3 portbench/progtrace.py --workload <cell> --seed <n> --seconds <s>

Its idle gaps and attribution put the profiler on the host clock by the
marker's launch, ``devtrace`` (busy seconds, ``run.py``'s gap names) by the
marker's device start, 0.3-0.5 ms later on an H100.  ``main``, with
``busy_gaps`` and ``harness_name``, goes once the harness builds its tracer
from ``TimelineTrace`` and ``devtrace`` takes the launch's offset.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import devtrace  # noqa: E402

#: records the armed timeline holds; a saturated 30 s window fills ~2^19
CAPACITY = 1 << 21
#: how far a launch may seem to start after its operation: Kineto's device
#: timestamps drift from its runtime calls' by 0 to ~1 ms within a window
LAUNCH_SLACK_NS = 1_000_000
CELLS = ["gnp_2e5.q25.saturate", "pl_2e5.f32.saturate", "pl_2e5.q25.zipf_saturate"]


class SpanIndex:
    """The innermost span covering a host instant, over a ``Timeline``'s
    records (spans nest within a thread; the innermost of all threads is the
    one that started last)."""

    def __init__(self, tl):
        from repro_torch.obs.trace import TIMELINE_SPANS

        self.tl = tl
        self.names = [TIMELINE_SPANS[tl.name[i]] for i in range(tl.n)]
        self.parent = tl.parents()
        by_thread: Dict[int, List[int]] = {}
        for i in range(tl.n):
            by_thread.setdefault(tl.thread[i], []).append(i)
        self.threads = []
        for rows in by_thread.values():
            rows.sort(key=lambda i: (tl.start[i], -tl.end[i], -i))
            self.threads.append(([tl.start[i] for i in rows], rows))

    def at(self, t: int) -> int:
        """The record covering ``t`` (ns, host clock) that started last, or -1."""
        best, best_start = -1, None
        for starts, rows in self.threads:
            j = bisect.bisect_right(starts, t) - 1
            if j < 0:
                continue
            i = rows[j]
            while i >= 0 and self.tl.end[i] < t:
                i = self.parent[i]
            if i >= 0 and (best < 0 or self.tl.start[i] > best_start):
                best, best_start = i, self.tl.start[i]
        return best


def is_copy_to_host(name: str) -> bool:
    return "DtoH" in name


def stream_order_topk(names: Sequence[str], combine: str = "combine_kernel",
                      spmv: str = "spmv_dangling_kernel") -> List[bool]:
    """Which of a stream's operations (names in device order) are top-K's:
    those after a wave's last ``combine`` (one that no ``spmv`` follows
    before the next copy to the host) up to and including its copies to the
    host.  The one stream runs operations in launch order."""
    out = [False] * len(names)
    pending: List[int] = []
    collecting = copied = False
    for i, n in enumerate(names):
        if copied and not is_copy_to_host(n):
            for j in pending:
                out[j] = True
            pending, collecting, copied = [], False, False
        if n == combine:
            pending, collecting = [], True
        elif n == spmv:
            pending, collecting = [], False
        elif collecting:
            pending.append(i)
            copied = copied or is_copy_to_host(n)
    if copied:
        for j in pending:
            out[j] = True
    return out


def blocks(call: str, op: Optional[str]) -> bool:
    """Whether the runtime call ``call``, which launched the operation named
    ``op`` (None: none in the window), returns only once the device has
    reached it: a synchronize, a synchronous copy, or an asynchronous copy
    to or from pageable host memory (the runtime waits for the stream first
    and copies through a staging buffer)."""
    if "Synchronize" in call or call == "cudaMemcpy":
        return True
    return call.startswith("cudaMemcpy") and op is not None and "Pageable" in op


def busy_gaps(iv: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi] between sorted busy intervals."""
    gaps, cur = [], lo
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def harness_name(items: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and items[i][1] >= t:
        return items[i][2]
    return devtrace.OUTSIDE


def attribute(ops, calls, off: int, index: SpanIndex):
    """``ops``: (device start, device end, name, correlation id), profiler
    clock, clipped to the window; ``calls`` the runtime calls, likewise.  An
    operation's launch is the last call under its correlation id that starts
    before the operation does, give or take ``LAUNCH_SLACK_NS``: Kineto puts
    the device's timestamps on the host's clock, and the two drift apart.  Returns per op the record its launch fell in (-1: none;
    None: no launch) and, per op whose launch starts after it, (name, ns)."""
    starts: Dict[int, List[int]] = {}
    for a, _b, _n, c in calls:
        if c > 0:
            starts.setdefault(c, []).append(a)
    for v in starts.values():
        v.sort()
    where, late = [], []
    for a, _b, n, corr in ops:
        cand = starts.get(corr)
        j = -1 if not cand else bisect.bisect_right(cand, a + LAUNCH_SLACK_NS) - 1
        if j < 0:
            where.append(None)
            continue
        if cand[j] > a:
            late.append((n, cand[j] - a))
        where.append(index.at(cand[j] - off))
    return where, late


def summarize(tl, ops, calls, off: int, lo: int, hi: int,
              harness_spans, iterations: Optional[int] = None) -> Dict:
    """The ``timeline`` entry and the program-named top-10 idle gaps, from a
    ``Timeline``, the window's device operations (profiler clock, sorted by
    start), the CUDA runtime calls ((start, end, name, correlation id),
    profiler clock), the marker offset (profiler − host) and the window
    [lo, hi] (profiler clock)."""
    index = SpanIndex(tl)
    names, parent = index.names, index.parent
    stats = tl.stats()
    waves = stats.get("ppr.wave", {}).get("count", 0)
    out: Dict = {"records": tl.n, "dropped": tl.dropped, "waves": waves}

    # device seconds by the span each operation was launched in
    op_s = [(b - a) / 1e9 for a, b, _n, _c in ops]
    total_s = sum(op_s)
    where, late = attribute(ops, calls, off, index)
    matched = sum(w is not None for w in where)
    device_s: Dict[str, float] = {}
    attributed = 0.0
    if matched:
        out["attribution"] = "launch"
        for w, s in zip(where, op_s):
            if w is not None and w >= 0:
                device_s[names[w]] = device_s.get(names[w], 0.0) + s
                attributed += s
        topk_s = device_s.get("ppr.wave.topk", 0.0)
        out["attributed_share"] = attributed / total_s if total_s else None
        # where the host blocks: each copy to the host by the span that made it
        copies: Dict[str, int] = {}
        for w, (_a, _b, n, _c) in zip(where, ops):
            if w is not None and is_copy_to_host(n):
                key = names[w] if w >= 0 else "-"
                copies[key] = copies.get(key, 0) + 1
        out["copies_to_host_by_span"] = copies
    else:
        out["attribution"] = "stream_order"
        mask = stream_order_topk([devtrace.short_name(n) for _a, _b, n, _c in ops])
        topk_s = sum(s for s, m in zip(op_s, mask) if m)
        out["attributed_share"] = None
    out["launch_matched"] = matched / len(ops) if ops else None
    late_names: Dict[str, int] = {}
    for n, _ns in late:
        late_names[devtrace.short_name(n)] = late_names.get(devtrace.short_name(n), 0) + 1
    out["launch_after_start"] = {
        "ops": len(late), "over_10us": sum(ns > 10_000 for _n, ns in late),
        "max_us": max((ns for _n, ns in late), default=0) / 1e3,
        "names": sorted(late_names.items(), key=lambda kv: -kv[1])[:3]}
    # host seconds inside runtime calls by the span that made them, and of
    # those the calls that block on the device
    op_names = {c: n for _a, _b, n, c in ops}
    in_calls: Dict[str, float] = {}
    blocked: Dict[str, float] = {}
    for a, b, n, c in calls:
        if lo <= a <= hi:
            i = index.at(a - off)
            span = names[i] if i >= 0 else "-"
            in_calls[f"{span} {n}"] = in_calls.get(f"{span} {n}", 0.0) + (b - a) / 1e9
            if blocks(n, op_names.get(c)):
                blocked[span] = blocked.get(span, 0.0) + (b - a) / 1e9
    out["runtime_s_by_span"] = sorted(([k, v] for k, v in in_calls.items()),
                                      key=lambda kv: -kv[1])[:12]
    out["blocked_s_by_span"] = blocked
    out["blocked_s"] = sum(v for k, v in blocked.items() if k != "-")
    out["topk_device_s"] = topk_s
    spans = {}
    for name, st in stats.items():
        spans[name] = dict(st, device_s=device_s.get(name, 0.0))
    out["spans"] = spans

    # consistency: each wave's steps inside its iterate, and all of them
    steps: Dict[int, List[int]] = {}
    for i, name in enumerate(names):
        if name == "ppr.step" and parent[i] >= 0:
            steps.setdefault(parent[i], []).append(tl.end[i] - tl.start[i])
    iterates = [i for i, name in enumerate(names) if name == "ppr.wave.iterate"]
    out["waves_steps_over_iterate"] = sum(
        sum(steps.get(i, ())) > tl.end[i] - tl.start[i] for i in iterates)
    if iterations is not None:
        out["iterates_without_all_steps"] = sum(
            len(steps.get(i, ())) != iterations for i in iterates)

    # idle gaps: all named, the longest ten kept.  One whose middle falls in
    # a device wait is the device idle while the host finishes a pageable,
    # synchronous copy to the host, or stalls there
    iv = sorted((a, b) for a, b, _n, _c in ops)
    gaps = busy_gaps(iv, lo, hi)
    items = sorted(harness_spans)
    h_starts = [s[0] for s in items]
    wait_gap, wait_long = 0, 0
    named = []
    for a, b in gaps:
        mid = (a + b) // 2 - off
        i = index.at(mid)
        if i >= 0 and names[i] == "ppr.wave.device_wait":
            wait_gap = max(wait_gap, b - a)
            wait_long += b - a > 50_000
        named.append((b - a, a, harness_name(items, h_starts, mid)
                      + ("" if i < 0 else "/" + names[i])))
    named.sort(key=lambda g: (-g[0], g[1]))
    out["device_wait_gap_max_us"] = wait_gap / 1e3
    out["device_wait_gaps_over_50us"] = wait_long
    idle = [[n, d / 1e9] for d, _a, n in named[:10]]
    return {"timeline": out, "idle_gaps": idle}


class TimelineTrace(devtrace.DeviceTrace):
    """``devtrace.DeviceTrace`` with the port's timeline armed while it
    traces; its summary adds the program's spans (module docstring)."""

    def __init__(self, torch, iterations: Optional[int] = None):
        super().__init__(torch)
        self.iterations = iterations
        self.timeline = None
        self.last: Optional[Dict] = None

    def start(self) -> None:
        from repro_torch.obs import trace

        super().start()
        self.timeline = trace.arm_timeline(CAPACITY)

    def stop(self) -> None:
        from repro_torch.obs import trace

        super().stop()
        trace.disarm_timeline()

    def summary(self, t0_ns: int, t1_ns: int, spans: devtrace.Spans) -> Optional[Dict]:
        base = super().summary(t0_ns, t1_ns, spans)
        if base is None:
            return None
        cuda = self.torch.autograd.DeviceType.CUDA
        dev, calls = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append(e)
            else:
                calls.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        marks = [e for e in dev if devtrace.MARKER in e.name()]
        first = min(marks, key=lambda e: e.start_ns())
        off_start = first.start_ns() - self.marker_host_ns
        launch = min((a for a, _b, _n, c in calls if c == first.correlation_id()),
                     default=None)
        # the marker's launch is nearer its host instant than its start is
        off = off_start if launch is None else launch - self.marker_host_ns
        lo, hi = t0_ns + off, t1_ns + off
        ops = []
        for e in dev:
            a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if b > a and devtrace.MARKER not in e.name():
                ops.append((a, b, e.name(), e.correlation_id()))
        ops.sort()
        got = summarize(self.timeline, ops, calls, off, lo, hi, spans.items,
                        self.iterations)
        got["timeline"]["marker_launch_to_start_us"] = (off_start - off) / 1e3
        base["idle_gaps"] = got["idle_gaps"]
        base["timeline"] = got["timeline"]
        self.last = base
        return base


# ---------------------------------------------------------------------------
# readers: ``run.device`` is the summary above (None, or without
# ``timeline``, where the tracer is devtrace's own: the readers return None)
# ---------------------------------------------------------------------------
def _timeline(run) -> Optional[Dict]:
    dev = getattr(run, "device", None)
    return None if not dev else dev.get("timeline")


def _mean_us(run, name: str) -> Optional[float]:
    tl = _timeline(run)
    st = None if tl is None else tl["spans"].get(name)
    return None if not st or not st["count"] else 1e6 * st["total_s"] / st["count"]


def topk_device_ms(run) -> Optional[float]:
    """Device ms a wave of the operations launched inside ``ppr.wave.topk``."""
    tl = _timeline(run)
    return None if tl is None or not tl["waves"] else 1e3 * tl["topk_device_s"] / tl["waves"]


def step_host_us(run) -> Optional[float]:
    """Mean host µs of one ``ppr.step`` (one ``fused_ppr_iteration`` call)."""
    return _mean_us(run, "ppr.step")


def device_wait_ms(run) -> Optional[float]:
    """Host ms a wave blocked on the device: the runtime calls that wait for
    the stream (``blocks``) made inside any program span, over the waves.
    That is the results' copies in ``ppr.wave.device_wait`` and the waits
    inside top-K's torch calls and ``plan``'s upload; the span
    ``ppr.wave.device_wait`` alone holds only the first."""
    tl = _timeline(run)
    return None if tl is None or not tl["waves"] else 1e3 * tl["blocked_s"] / tl["waves"]


def submit_host_us(run) -> Optional[float]:
    """Mean host µs of one ``ppr.submit``."""
    return _mean_us(run, "ppr.submit")


READERS = {"topk_device_ms.saturate": topk_device_ms,
           "step_host_us.saturate": step_host_us,
           "device_wait_ms.saturate": device_wait_ms,
           "submit_host_us.saturate": submit_host_us}

METRICS = [
    {"name": "topk_device_ms.saturate", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "kernels: fused_ppr and top-K",
     "moves": "queries_per_s", "workloads": CELLS},
    {"name": "step_host_us.saturate", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "engine: engine/fused.py",
     "moves": "queries_per_s", "workloads": CELLS},
    {"name": "device_wait_ms.saturate", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "service: ppr_serving/service.py",
     "moves": "queries_per_s", "workloads": CELLS},
    {"name": "submit_host_us.saturate", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "service: ppr_serving/cache.py",
     "moves": "queries_per_s", "workloads": CELLS},
]


def timeline_info(tl: Dict) -> Dict:
    """What a result line's ``info`` carries of the timeline."""
    by_dev = sorted(((n, s["device_s"]) for n, s in tl["spans"].items()
                     if s["device_s"] > 0), key=lambda kv: -kv[1])
    keep = ("records", "waves", "attribution", "attributed_share", "launch_matched",
            "launch_after_start", "copies_to_host_by_span",
            "marker_launch_to_start_us",
            "device_wait_gap_max_us", "device_wait_gaps_over_50us",
            "runtime_s_by_span", "blocked_s_by_span", "waves_steps_over_iterate",
            "iterates_without_all_steps", "topk_device_s")
    return dict({k: tl[k] for k in keep if k in tl},
                timeline_dropped=tl["dropped"], device_s_by_span=by_dev,
                spans=tl["spans"])


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / sub)
    sys.path[:0] = [str(root / "src"), str(root)]
    from portbench import harness, run

    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"progtrace: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    made: List[TimelineTrace] = []
    iterations = int(cell.config["service"]["iterations"])
    # the harness builds its tracer as ``devtrace.DeviceTrace(torch)``
    devtrace.DeviceTrace = lambda torch_: made.append(
        TimelineTrace(torch_, iterations)) or made[-1]
    result = harness.run_cell(cell, args.seed, args.seconds, True,
                              device="cuda", t_start=t_start)
    if made and made[0].last is not None:
        run_ns = SimpleNamespace(device=made[0].last)
        for m in METRICS:
            value = READERS[m["name"]](run_ns)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["info"]["timeline"] = timeline_info(made[0].last["timeline"])
    bad = run.loaded_forbidden()
    if bad:
        print(f"progtrace: the process holds {bad} after the window", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = run.power_limit()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
