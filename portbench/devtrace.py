"""The device's side of a traced run, from ``torch.profiler``.

Only device activity is recorded (kernels, copies, memsets), read from the
raw Kineto events: building ``prof.events()`` for the ~10^5 operations of a
window would take minutes.  The profiler's clock is tied to the host's by a
marker kernel launched on an idle device right after the profiler starts.

From the events and the harness's own host spans (``Spans``) come: the
device-busy seconds inside the window (the union of the operations'
intervals), the operations that took most time, and the longest idle gaps,
each named by the harness call the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"          # what torch.cuda._sleep launches
OUTSIDE = "portbench.between_calls"


class Spans:
    """Host intervals of the harness's calls into the program (ns of
    ``time.perf_counter_ns``), recorded only in a traced run."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Tuple[int, int, str]] = []

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.items.append((t0, t1, name))


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, templates and
    arguments, in the characters a name may have."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    name = name.split("<")[0].split("(")[0].split("::")[-1].strip() or name
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64] or "unnamed"


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.marker_host_ns = None

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_host_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.stop()

    def summary(self, t0_ns: int, t1_ns: int, spans: Spans) -> Optional[Dict]:
        """Busy seconds, top operations and longest gaps in [t0_ns, t1_ns]
        (host clock), or None when the trace holds no device operation."""
        cuda = self.torch.autograd.DeviceType.CUDA
        events = [e for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and not e.is_user_annotation()]
        marks = [e.start_ns() for e in events if MARKER in e.name()]
        if not marks:
            return None
        off = min(marks) - self.marker_host_ns          # profiler - host clock
        lo, hi = t0_ns + off, t1_ns + off
        iv, by_name = [], {}
        for e in events:
            a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if b <= a or MARKER in e.name():
                continue
            iv.append((a, b))
            n = short_name(e.name())
            by_name[n] = by_name.get(n, 0) + (b - a)
        if not iv:
            return None
        iv.sort()
        busy, gaps = 0, []
        cur_a, cur_b = iv[0]
        if cur_a > lo:
            gaps.append((lo, cur_a))
        for a, b in iv[1:]:
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        if cur_b < hi:
            gaps.append((cur_b, hi))
        starts = [s[0] for s in spans.items]

        def doing(mid_host: int) -> str:
            i = bisect.bisect_right(starts, mid_host) - 1
            if i >= 0 and spans.items[i][1] >= mid_host:
                return spans.items[i][2]
            return OUTSIDE

        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[doing((a + b) // 2 - off), (b - a) / 1e9] for a, b in gaps[:10]]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
                "device_ops": [[n, s / 1e9] for n, s in ops],
                "idle_gaps": idle, "device_events": len(iv)}
