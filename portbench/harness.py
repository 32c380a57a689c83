"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the graph and the service) and a traffic mix
(``traffic/<traffic>.json``: precision, k, vertex distribution, loop,
cache, deltas, and the check it is judged by, ``checks/<check>.json``).
Each metric the cell reports is read by ``metrics/<metric>.py``.  Nothing
here knows a cell by its name: a new cell is new data files.

The window drives the served path of the port: ``PPRService`` with the
graph on the fused engine family, ``submit`` / ``poll`` / ``flush``, and
``apply_delta`` when the traffic has deltas.  Every query's answer is
booked by a done-callback; after the window a sample of the answers, drawn
from the seed, is judged against the plain reference (``verdict.py``) on
the graph each was served on.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from portbench import arrivals, devtrace, graphgen, verdict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GRAPH = "g"                      # the one graph a run registers


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files, from ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in bench['workloads']]})")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload))


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Book:
    """The window's queries, one row each, filled in by done-callbacks."""

    def __init__(self, k: int, cap: int = 1 << 15):
        self.k, self.n, self.resolved = k, 0, 0
        self._alloc(cap)

    def _alloc(self, cap: int) -> None:
        old = getattr(self, "vertex", None)
        new = {"vertex": np.zeros(cap, np.int64), "version": np.zeros(cap, np.int32),
               "due": np.zeros(cap), "done": np.full(cap, np.nan),
               "failed": np.zeros(cap, bool), "cache": np.zeros(cap, bool),
               "ids": np.zeros((cap, self.k), np.int64),
               "scores": np.zeros((cap, self.k))}
        for name, arr in new.items():
            if old is not None:
                arr[: self.n] = getattr(self, name)[: self.n]
            setattr(self, name, arr)

    def add(self, vertex: int, version: int, due: float) -> int:
        if self.n == self.vertex.shape[0]:
            self._alloc(2 * self.n)
        i = self.n
        self.vertex[i], self.version[i], self.due[i] = vertex, version, due
        self.n += 1
        return i

    def resolve(self, i: int, fut) -> None:
        self.done[i] = time.perf_counter()
        self.resolved += 1
        exc = fut.exception(timeout=0)
        if exc is not None:
            self.failed[i] = True
            return
        rec = fut.result(timeout=0)
        m = min(rec.vertices.shape[0], self.k)     # a short list is judged bad
        self.ids[i, :m], self.ids[i, m:] = rec.vertices[:m], -1
        self.scores[i, :m], self.scores[i, m:] = rec.scores[:m], np.nan
        self.cache[i] = rec.source == "cache"


def _edges_at(src, dst, deltas, j):
    """The edge list after the first ``j`` deltas."""
    if j == 0:
        return src, dst
    keep = np.ones(src.shape[0], bool)
    for d in deltas[:j]:
        keep[d["remove"]] = False
    return (np.concatenate([src[keep]] + [d["add_src"] for d in deltas[:j]]),
            np.concatenate([dst[keep]] + [d["add_dst"] for d in deltas[:j]]))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             keep_latencies: Optional[list] = None) -> Dict:
    """One run; returns the result line (``checks`` last) and extra ``info``.
    ``keep_latencies`` (a list) receives an open loop's latencies (ms, in
    due order)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from repro_torch.core.coo import COOGraph
    from repro_torch.graph_updates import EdgeDelta
    from repro_torch.ppr_serving import PPRQuery, PPRService

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    gspec, sspec = cfg["graph"], cfg["service"]
    nv, kappa, k = int(gspec["num_vertices"]), int(sspec["kappa"]), int(tr["k"])
    precision = tr["precision"]
    spans = devtrace.Spans(trace)
    ns = time.perf_counter_ns
    marks = {"imported": time.perf_counter()}

    # ---- inputs, all from the seed --------------------------------------
    src, dst = graphgen.make_graph(gspec, arrivals.rng_for(seed, "graph"))
    dspec = tr.get("deltas")
    dtimes = arrivals.delta_times(dspec, seconds)
    deltas = (graphgen.delta_batch(src, nv, len(dtimes), dspec["n_add"],
                                   dspec["n_remove"], arrivals.rng_for(seed, "deltas"))
              if len(dtimes) else [])
    marks["inputs"] = time.perf_counter()

    # ---- the system under test ------------------------------------------
    svc = PPRService(kappa=kappa, iterations=int(sspec["iterations"]),
                     alpha=float(sspec["alpha"]), max_wait=float(tr["max_wait_s"]),
                     cache_capacity=int(tr["cache_capacity"]), device=dev)
    svc.register_graph(GRAPH, COOGraph.from_edges(src, dst, nv),
                       formats=sspec["formats"], engine=sspec["engine"])
    marks["registered"] = time.perf_counter()
    # warm-up: full waves and a partial one at the traffic's precision, then
    # (a cache's traffic) the cache filled from the traffic's own distribution
    warm = arrivals.rng_for(seed, "warmup").integers(0, nv, 2 * kappa + kappa // 2)
    svc.run_batch([PPRQuery(GRAPH, int(v), k=k, precision=precision) for v in warm])
    if tr.get("cache_warm_queries"):
        fill = arrivals.VertexStream(tr["vertices"], nv, seed, stream="warmup")
        svc.run_batch([PPRQuery(GRAPH, int(v), k=k, precision=precision)
                       for v in fill.draw(int(tr["cache_warm_queries"]))])
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    svc.telemetry.reset()
    marks["warm"] = time.perf_counter()

    book = Book(k)
    version = 0

    def submit(vertex: int, due: float) -> None:
        i = book.add(vertex, version, due)
        fut = svc.submit(PPRQuery(GRAPH, vertex, k=k, precision=precision))
        fut.add_done_callback(lambda f, i=i: book.resolve(i, f))

    probe = time.perf_counter()
    sum(i * i for i in range(300_000))    # the host's speed in this run
    probe = time.perf_counter() - probe
    tracer = devtrace.DeviceTrace(torch) if trace else None
    if tracer is not None:
        tracer.start()
    gc.collect()
    gc.freeze()
    apply_s: List[float] = []
    loop = tr["loop"]
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t0_ns = ns()
    if loop["kind"] == "closed":
        target = kappa * int(loop["outstanding_per_kappa"])
        stream = arrivals.VertexStream(tr["vertices"], nv, seed)
        t_stop = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= t_stop:
                break
            if version < len(dtimes) and now - t0 >= dtimes[version]:
                a = ns()
                svc.flush()
                b = ns()
                spans.add("portbench.flush", a, b)
                d = deltas[version]
                rep = svc.apply_delta(GRAPH, EdgeDelta(
                    add_src=d["add_src"], add_dst=d["add_dst"],
                    remove_src=src[d["remove"]], remove_dst=dst[d["remove"]]))
                spans.add("portbench.apply_delta", b, ns())
                apply_s.append(float(rep["apply_s"]))
                version += 1
                continue
            a = ns()
            while book.n - book.resolved < target:
                submit(stream.next(), time.perf_counter())
            b = ns()
            spans.add("portbench.submit", a, b)
            svc.poll()
            spans.add("portbench.poll", b, ns())
    elif loop["kind"] == "open":
        due = arrivals.open_arrivals(float(loop["rate_per_s"]), seconds, seed)
        verts = arrivals.VertexStream(tr["vertices"], nv, seed).draw(due.shape[0])
        i, n_due = 0, due.shape[0]
        while True:
            now = time.perf_counter() - t0
            if i < n_due and due[i] <= now:
                a = ns()
                j = int(np.searchsorted(due, now, side="right"))
                for q in range(i, j):
                    submit(int(verts[q]), t0 + due[q])
                i = j
                spans.add("portbench.submit", a, ns())
            a = ns()
            if svc.poll():
                spans.add("portbench.poll", a, ns())
            if i >= n_due and (book.resolved == book.n or now > seconds + 60.0):
                break                      # all answered, or a minute past the close
            wait = min((due[i] if i < n_due else now + 1.0)
                       - (time.perf_counter() - t0), 2e-4)
            if wait > 0:
                a = ns()
                time.sleep(wait)
                spans.add("portbench.wait", a, ns())
    else:
        raise ValueError(f"unknown loop kind {loop['kind']!r}")
    a = ns()
    svc.flush()
    if cuda:
        torch.cuda.synchronize(dev)
    t1_ns = ns()
    spans.add("portbench.flush", a, t1_ns)
    t_last = time.perf_counter()
    gc.unfreeze()

    # ---- readings of the program, before its state is freed -------------
    dev_summary = None
    if tracer is not None:
        tracer.stop()
        dev_summary = tracer.summary(t0_ns, t1_ns, spans)
    telemetry = svc.telemetry_summary()
    stages = svc.telemetry.stage_stats()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    g_src = svc.registered_graph(GRAPH).source
    num_dangling = int(np.count_nonzero(g_src.dangling))
    num_edges = int(g_src.num_edges)
    del svc, g_src, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check ---------------------------------------------------------
    t_check = time.perf_counter()
    n = book.n
    failed = int(book.failed[:n].sum())
    unanswered = int(np.isnan(book.done[:n]).sum())
    good = np.nonzero(~book.failed[:n] & ~np.isnan(book.done[:n]))[0]
    check = json.loads((HERE / "checks" / f"{tr['check']}.json").read_text())
    rows = good[verdict.sample_rows(good.shape[0], int(check["sample"]),
                                    arrivals.rng_for(seed, "sample"))]
    answers = {"vertex": book.vertex[rows], "version": book.version[rows],
               "ids": book.ids[rows], "scores": book.scores[rows]}
    numbers = verdict.judge(
        check, lambda j: _edges_at(src, dst, deltas, j) + (nv,), answers, dev,
        alpha=float(sspec["alpha"]), iterations=int(sspec["iterations"]))
    numbers["unanswered"] = unanswered
    limits = dict(check["limits"], unanswered=0)
    checked = numbers.pop("checked")
    correct = checked > 0 and all(numbers[m] <= limits[m] for m in limits)
    check_s = time.perf_counter() - t_check

    # ---- metrics -------------------------------------------------------------
    lat_ms = None
    if loop["kind"] == "open":
        lat_ms = (book.done[:n] - book.due[:n]) * 1e3
        lat_ms[book.failed[:n] | np.isnan(lat_ms)] = np.inf
        if keep_latencies is not None:
            keep_latencies.append(lat_ms)
    run = SimpleNamespace(
        setup_s=setup_s, window_s=t_last - t0, seconds=seconds,
        answered=int(good.shape[0]), attempted=n, failed=failed,
        latencies_ms=lat_ms, telemetry=telemetry, stages=stages,
        apply_s=apply_s, device=dev_summary, kappa=kappa,
        iterations=int(sspec["iterations"]), k=k, num_vertices=nv,
        num_edges=num_edges, num_dangling=num_dangling)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_info}
    if dev_summary is not None:
        device_info["busy_s"] = dev_summary["busy_s"]
        device_info["window_s"] = dev_summary["window_s"]
        result["breakdown"] = {"device_ops": dev_summary["device_ops"],
                               "idle_gaps": dev_summary["idle_gaps"]}
    info = {"answered": run.answered, "window_s": run.window_s,
            "setup_parts_s": {"import": marks["imported"] - t_start,
                              "inputs": marks["inputs"] - marks["imported"],
                              "register": marks["registered"] - marks["inputs"],
                              "warm_up": marks["warm"] - marks["registered"],
                              "window_prep": t0 - marks["warm"]},
            "checked": checked, "checked_from_cache": int(book.cache[rows].sum()),
            "versions_checked": sorted(set(int(v) for v in answers["version"])),
            "check_s": check_s, "apply_s": apply_s,
            "waves": telemetry.get("waves"),
            "num_edges": num_edges, "num_dangling": num_dangling}
    done = book.done[:n][~np.isnan(book.done[:n])] - t0
    info["answered_per_s"] = np.bincount(done.astype(np.int64).clip(0)).tolist()
    info["host_probe_ms"] = probe * 1e3
    if lat_ms is not None:
        late = np.nanmax(np.where(book.cache[:n], lat_ms, np.nan)) \
            if book.cache[:n].any() else None
        info["latency_p50_ms"] = float(np.percentile(lat_ms, 50))
        info["cache_answer_latency_max_ms"] = late
    if dev_summary is not None:
        info["device_events"] = dev_summary["device_events"]
    result["info"] = info
    result["checks"] = {m: {"value": numbers[m], "limit": limits[m]} for m in limits}
    return result
