#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card, nvcc and the
repo's Python dependencies.  The script imports only ``repro_torch`` (from
``src/``), torch, numpy and scipy.  Every check raises; any failed phase
exits non-zero.  It prints, in order:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   the time to build the kernels from ``src/repro_torch/csrc``, and the
   device operations one call of each LM kernel runs (small inputs);
2. kernel parity: each kernel wrapper on the card against its plain PyTorch
   version on the same inputs, on the paper's ``gnp_2e5`` (dangling vertices
   live) and ``pl_2e5`` graphs at K=16, v_tile=512, packet=256, in float32
   and Q1.25; the host layouts' padding factors, the dst stream's slices
   and CTAs, and its device bytes against those of the padded packet layouts;
3. the served path: ``PPRService(kappa=16, iterations=10, device="cuda")``
   on ``gnp_2e5`` with ``engine="fused"`` and ``engine="single"``, 64 queries
   at precision 26 and 32 in float32 each, compared with each other and with
   the scipy float64 oracle; the fused kernels' launch counts over the run;
   the host time of a served ``fused_ppr_iteration`` call, and the device's
   busy share of three fused passes under ``torch.profiler``;
4. early exit on ``pl_2e5`` (``early_exit``, Q1.19, budgets 40 and 120):
   fused and single return identical states after identical iteration counts;
5. the SpMV path (``core.spmv.spmv_kernel``) with its launch count, and the
   times: CUDA-event medians of one call of each kernel as a caller that
   waits sees it (``ms``, the host's enqueue included, as every earlier
   version of this script measured), of its plain version and of one library
   call where PyTorch has one; beside them ``device_ms``, the same calls
   with the host's enqueue hidden behind a queued sleep; the least time the
   card could take (bytes over 3.35 TB/s), the device operations one call
   runs (``torch.profiler``), and the service's waves/s and queries/s;
6. the LM kernels against their plain versions at gemma-2b's shapes:
   ``flash_attention_gqa`` (B=2, S=4096, d=256; H=8/KV=1 causal, and
   H=8/KV=4 with gemma3-4b's window of 1024) and ``quantized_matmul``
   (M of 128 and 4096 against gemma-2b's w_gate/w_up and w_down), each in
   float32 and bfloat16, with kernel, plain and library times and the bound
   (bytes over 3.35 TB/s or FLOPs over the type's peak, the larger);
7. gemma-2b served at full width (18 layers, 2.51 B float32 master
   parameters drawn on the card from seed 0): (a) in float32, decode equals
   forward and ``ServingEngine`` equals per-request greedy decoding; (b)
   layer 0's q/k/v of a B=2, S=2048 prefill through the model's ``_attend``
   and through ``flash_attention_gqa``, and its MLP through
   ``quantized_matmul`` (the launches counted here are the kernels' path
   launches); (c) in bfloat16, ``launch/serve.py``'s defaults timed over
   several passes (a smoke reading of a host-bound loop): tokens/s, prefill
   ms, decode-step ms p50/p95; (d) the same at a serving shape: one wave of
   32 requests, 1,024-token prompts, 128 new tokens each;
8. a ``{"kernels": [...]}`` JSON line, then the card line, then the
   ``{"ok": true, ...}`` line last.

Everything too long for the end of the output goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

K = 16
V_TILE = 512
PACKET = 256
ALPHA = 0.85
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
PEAK_FLOPS = {"f32": 67e12,        # float32 CUDA cores, NVIDIA data sheet
              "bf16": 989e12}      # bf16 dense tensor cores
WARMUP, REPEATS = 3, 15


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _graphs():
    from repro_torch.graphs import erdos_renyi, holme_kim_powerlaw
    # the paper's Table 1 sizes, as repro.graphs.paper_graph_suite(scale=1.0)
    return {"gnp_2e5": erdos_renyi(200_000, 2_000_000, seed=1),
            "pl_2e5": holme_kim_powerlaw(200_000, m=10, seed=5)}


def _time_ms(torch, fn, repeats=REPEATS, hide_host=False):
    """Median CUDA-event time of ``fn()`` in ms, after warm-up: what a caller
    that waits sees, the host's enqueue included.

    With ``hide_host`` a ``torch.cuda._sleep`` of ~0.5 ms is queued first, so
    the host has enqueued the call's launches before the start event runs:
    the time is the device's, from the first launch to the end of the last."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _roofline(nbytes: float, flops: float, dom: str):
    """(bound ms, "bytes" or "operations"): the larger of bytes over HBM rate
    and FLOPs over the peak of the inputs' type."""
    by_bytes = _bound_ms(nbytes)
    by_ops = flops / PEAK_FLOPS[dom] * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 2 + 5: kernels against their plain versions
# ---------------------------------------------------------------------------
def _inputs(np, g, fmt, seed):
    """A state P [V, K] and V̄ [V, K] from a seed, in the domain of ``fmt``."""
    rng = np.random.default_rng(seed)
    v = g.num_vertices
    pers = rng.choice(v, K, replace=False)
    p = (rng.random((v, K)) * (2.0 / v)).astype(np.float32)
    p[pers, np.arange(K)] += 0.15
    vm = np.zeros((v, K), np.float32)
    vm[pers, np.arange(K)] = 1.0
    if fmt is None:
        return p, vm
    raw = np.floor(p.astype(np.float64) * fmt.scale).astype(np.uint32)
    return raw.view(np.int32), (vm * fmt.scale).astype(np.uint32).view(np.int32)


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0].split("::")[-1].strip() or name


def _on_device(torch, e) -> bool:
    """A profiler event that ran on the card (a kernel, memset or copy), not
    a user range mirrored onto the device's timeline."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _device_ops(torch, fn, calls=3, tries=3):
    """(device operations one call of ``fn`` runs — kernels, memsets, copies —,
    the device ms one call spends in each, by name, and the profiles taken),
    from ``torch.profiler`` over ``calls`` calls after one warm-up step of the
    profiler, whose records its schedule discards.  The count is exact: a
    profile counts only if every name's device events number a whole
    multiple of ``calls``, so that they total calls x n; else it is taken
    again, up to ``tries`` times, and the count is None if none did."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        ready = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda prof: ready.append(prof.events())) as prof:
            for _ in range(2):                  # the warm-up step, then the active one
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        spans = {}
        for e in (ready[0] if ready else []):
            if _on_device(torch, e):
                spans.setdefault(_short(e.name), []).append(
                    (e.time_range.end - e.time_range.start) / 1e3)
        if spans and all(len(t) % calls == 0 for t in spans.values()):
            return (sum(len(t) for t in spans.values()) // calls,
                    {name: statistics.mean(t) for name, t in spans.items()}, attempt)
    return None, {}, tries


def _widest_slice(np, st):
    """The most rows a slice of the stream spans, empty rows included: what
    a walk over rows, rather than over edges, would visit in one slice."""
    if not st.num_edges:
        return 0
    ends = st.row_ptr[st.nz_rows + 1]
    last_edge = np.minimum((np.arange(st.num_slices) + 1) * st.slice_edges,
                           st.num_edges) - 1
    q_last = np.searchsorted(ends, last_edge, side="right")
    return int((st.nz_rows[q_last] - st.nz_rows[st.slice_row[:-1]]).max()) + 1


def _padded_upload_bytes(lay, blocked, n_formats):
    """Device bytes the padded packet layouts would take for a registered
    graph (fused: int16 x2/y2 rows, row_off, row_src, one value row-set a
    format) and for the SpMV path (int16 packets, dst_start, packet_src, the
    dst mask, values)."""
    rows = lay.num_rows
    fused = 2 * 2 * rows * PACKET + 4 * (lay.n_blk + 1) + 4 * (rows - 1) \
        + n_formats * 4 * rows * PACKET
    slots = blocked.num_packets * PACKET
    spmv = 2 * 2 * slots + 4 * (blocked.n_dst + 1) + 4 * blocked.num_packets \
        + blocked.n_dst * V_TILE + n_formats * 4 * slots
    return fused, spmv


def _timings(torch, row, kernel, plain, plain_repeats=10):
    """A kernel row's times: ``ms`` (a call as a caller that waits sees it),
    ``device_ms`` (the host's enqueue hidden), ``plain_ms`` (the plain
    version's call), the device operations a call runs and the device ms of
    each; ``library_ms`` stays None until ``_library_timings`` sets it."""
    (row["device_ops_per_call"], row["device_ms_by_kernel"],
     row["device_ops_profiles"]) = _device_ops(torch, kernel)
    row["ms"] = _time_ms(torch, kernel)
    row["device_ms"] = _time_ms(torch, kernel, hide_host=True)
    row["plain_ms"] = _time_ms(torch, plain, repeats=plain_repeats)
    row["library_ms"] = row["library_device_ms"] = None


def _library_timings(torch, row, library):
    """One library call's ``library_ms`` and ``library_device_ms``, the spans
    of ``ms`` and ``device_ms``."""
    row["library_ms"] = _time_ms(torch, library)
    row["library_device_ms"] = _time_ms(torch, library, hide_host=True)


def kernel_phase(torch, np, graphs, dev, timing: bool):
    from repro_torch.core.coo import BlockedCOO
    from repro_torch.core.fixed_point import Q1_25
    from repro_torch.kernels import ops
    from repro_torch.kernels.coo_spmv import coo_spmv_kernel, coo_spmv_plain
    from repro_torch.kernels.fused_ppr import (dangling_mass, dangling_mass_plain,
                                               fused_ppr_iteration, fused_ppr_plain)
    from repro_torch.ppr_serving.engine.fused import FusedRegisteredGraph

    rows, streams = [], {}
    for gname, g in graphs.items():
        blocked = BlockedCOO.build(g, v_tile=V_TILE, packet=PACKET)
        frg = FusedRegisteredGraph(gname, g, packet=PACKET, v_tile=V_TILE,
                                   device=dev)
        lay = frg.fused_layout()
        st = frg.fused_stream()
        topo = frg.fused_topology()
        sst = ops.dst_stream(blocked)
        fused_slots = (lay.num_rows - 1) * PACKET
        v, e = g.num_vertices, g.num_edges
        # device bytes of the registered graph's stream (topology + f32 and
        # Q1.25 values) against the padded packet layouts of the same
        stream_bytes = sum(t.numel() * t.element_size() for t in (
            topo.row_ptr, topo.col, topo.nz_rows, topo.slice_row)) + 2 * 4 * st.num_edges
        padded_fused, padded_spmv = _padded_upload_bytes(lay, blocked, 2)
        stream_spmv = 4 * (sst.num_rows + 1) + 4 * sst.nz_rows.size \
            + 4 * (sst.num_slices + 1) + 3 * 4 * sst.num_edges
        streams[gname] = dict(
            edges=e, slice_edges=st.slice_edges, slices=st.num_slices, ctas=st.num_ctas,
            max_row=int(np.diff(st.row_ptr).max()), empty_rows=int((np.diff(st.row_ptr) == 0).sum()),
            widest_slice_rows=_widest_slice(np, st),
            fused_stream_bytes=stream_bytes, fused_padded_bytes=padded_fused,
            spmv_stream_bytes=stream_spmv, spmv_padded_bytes=padded_spmv)
        print(f"[layout] {gname}: |V|={v} |E|={e} dangling={int(g.dangling.sum())} "
              f"BlockedCOO packets={blocked.num_packets} pad_overhead="
              f"{blocked.pad_overhead:.4f} fused rows={lay.num_rows - 1} "
              f"pad={fused_slots / e:.4f} (host only)")
        print(f"[stream] {gname}: {st.num_edges} edges, slices of {st.slice_edges} "
              f"edges, {st.num_slices} slices, {st.num_ctas} CTAs; longest row "
              f"{streams[gname]['max_row']}, empty rows {streams[gname]['empty_rows']}, "
              f"a slice spans at most {streams[gname]['widest_slice_rows']} rows; "
              f"device bytes, f32 + Q1.25: fused stream {stream_bytes} against the "
              f"padded {padded_fused} ({padded_fused / stream_bytes:.2f}x); SpMV stream "
              f"{stream_spmv} against {padded_spmv} ({padded_spmv / stream_spmv:.2f}x)")
        dang_idx = frg.fused_dangling()
        n_dang = int(dang_idx.shape[0])
        for fmt in (None, Q1_25):
            dom = "f32" if fmt is None else fmt.name
            p_np, vm_np = _inputs(np, g, fmt, seed=len(gname) + (0 if fmt is None else 7))
            p = torch.as_tensor(p_np, device=dev)
            vm = torch.as_tensor(vm_np, device=dev)

            # -- kernel 1: coo_spmv ------------------------------------------
            pp = ops.pad_p_for_blocks(p, blocked)
            args = (*ops.spmv_operands(blocked, dev, fmt), pp)
            kw = dict(frac_bits=None if fmt is None else fmt.frac_bits)
            out_k = coo_spmv_kernel(*args, **kw)
            out_p = coo_spmv_plain(*args, **kw)
            if fmt is None:
                err = float((out_k - out_p).abs().max())
                if not torch.allclose(out_k, out_p, rtol=1e-5, atol=1e-8):
                    _fail(f"coo_spmv {gname} f32: max abs err {err}")
            else:
                err = 0.0
                if not torch.equal(out_k, out_p):
                    _fail(f"coo_spmv {gname} {dom}: raw bits differ")
            row = dict(kernel="coo_spmv", graph=gname, domain=dom, max_abs_err=err)
            # the stream's col and val (4 + 4 B an edge), row_ptr, the slice
            # schedule (nz_rows, slice_row), P once and the output once
            row["bound_ms"] = _bound_ms(
                sst.num_edges * 8 + (sst.num_rows + 1) * 4 + sst.nz_rows.size * 4
                + (sst.num_slices + 1) * 4 + pp.numel() * 4 + out_k.numel() * 4)
            # the function's bound: the edge list and P and out over |V| rows
            row["unpadded_bound_ms"] = _bound_ms(e * 8 + 2 * v * K * 4)
            if timing:
                _timings(torch, row, lambda: coo_spmv_kernel(*args, **kw),
                         lambda: coo_spmv_plain(*args, **kw))
                if fmt is None:   # one torch.sparse.mm on a CSR copy of X
                    X = torch.sparse_coo_tensor(
                        torch.as_tensor(np.stack([g.x, g.y]).astype(np.int64), device=dev),
                        torch.as_tensor(g.val, device=dev), (v, v)).coalesce().to_sparse_csr()
                    _library_timings(torch, row, lambda: torch.sparse.mm(X, p))
                    ref = torch.sparse.mm(X, p)
                    lib_err = float((ref - out_k[:v]).abs().max())
                    if lib_err > 1e-6:
                        _fail(f"coo_spmv {gname} f32 vs torch.sparse.mm: {lib_err}")
                    del X, ref
            rows.append(row)

            # -- kernel 2: the fused iteration (A + B) ----------------------
            fargs = (topo, frg.fused_values(fmt), dang_idx, vm, p)
            fkw = dict(alpha=ALPHA, fmt=fmt)
            pn_k, res_k = fused_ppr_iteration(*fargs, **fkw)
            pn_p, res_p = fused_ppr_plain(*fargs, **fkw)
            if fmt is None:
                err = float((pn_k - pn_p).abs().max())
                if err > 1e-6 or not torch.allclose(pn_k, pn_p, rtol=1e-5, atol=1e-9):
                    _fail(f"fused {gname} f32: P_next max abs err {err} "
                          f"(limits: rtol 1e-5 + atol 1e-9, and 1e-6)")
                for r in (0, 2):
                    if not torch.allclose(res_k[r], res_p[r], rtol=1e-4, atol=0.0):
                        _fail(f"fused {gname} f32: residual row {r} {res_k[r]} vs {res_p[r]}")
                if float((res_k[1] - res_p[1]).abs().max()) > 1e-6:
                    _fail(f"fused {gname} f32: inf residual {res_k[1]} vs {res_p[1]}")
            else:
                err = 0.0
                if not torch.equal(pn_k, pn_p):
                    _fail(f"fused {gname} {dom}: P_next raw bits differ")
                if not torch.equal(res_k[1], res_p[1]):
                    _fail(f"fused {gname} {dom}: inf residual differs")
                for r in (0, 2):
                    if not torch.allclose(res_k[r], res_p[r], rtol=1e-4, atol=0.0):
                        _fail(f"fused {gname} {dom}: residual row {r}")
            row = dict(kernel="fused_ppr_iteration", graph=gname, domain=dom,
                       max_abs_err=err)
            # stream bytes as above; P and V̄ read once, P_next written once
            state = v * K * 4
            row["bound_ms"] = _bound_ms(
                st.num_edges * 8 + (v + 1) * 4 + st.nz_rows.size * 4
                + (st.num_slices + 1) * 4 + n_dang * 4 + 3 * state + 3 * K * 4)
            row["unpadded_bound_ms"] = _bound_ms(
                e * 8 + n_dang * 4 + 3 * state + 3 * K * 4)
            if timing:
                _timings(torch, row, lambda: fused_ppr_iteration(*fargs, **fkw),
                         lambda: fused_ppr_plain(*fargs, **fkw))
                ops_n = row["device_ops_per_call"]
                if ops_n is not None and ops_n > 3:
                    _fail(f"fused_ppr_iteration {gname} {dom}: {ops_n} device operations "
                          f"a call (at most 3: two kernels and a fill)")
            rows.append(row)

            dm_k = dangling_mass(p, dang_idx, fixed=fmt is not None)
            dm_p = dangling_mass_plain(p, dang_idx, fixed=fmt is not None)
            if fmt is None:
                err = float((dm_k - dm_p).abs().max())
                if not torch.allclose(dm_k, dm_p, rtol=1e-5, atol=1e-8):
                    _fail(f"dangling_mass {gname} f32: {dm_k} vs {dm_p}")
            else:
                err = 0.0
                if not torch.equal(dm_k, dm_p):
                    _fail(f"dangling_mass {gname} {dom}: raw bits differ")
            nbytes = n_dang * (4 + K * 4) + K * 4
            row = dict(kernel="fused_ppr_dangling_mass", graph=gname, domain=dom,
                       max_abs_err=err, bound_ms=_bound_ms(nbytes),
                       unpadded_bound_ms=_bound_ms(nbytes))
            if timing:
                _timings(torch, row,
                         lambda: dangling_mass(p, dang_idx, fixed=fmt is not None),
                         lambda: dangling_mass_plain(p, dang_idx, fixed=fmt is not None),
                         plain_repeats=REPEATS)
                if fmt is None:   # one dense product d̄ᵀP, the reference's float path
                    d = torch.as_tensor(g.dangling.astype(np.float32), device=dev)
                    _library_timings(torch, row, lambda: d @ p)
            rows.append(row)
            print(f"[parity] {gname} {dom}: coo_spmv, fused_ppr_iteration, "
                  f"dangling_mass pass")
    return rows, streams


# ---------------------------------------------------------------------------
# phase 3: the served path
# ---------------------------------------------------------------------------
def _serve(torch, svc_cls, query_cls, g, engine, queries, dev, passes):
    """Serve ``queries`` once to warm up, then ``passes`` timed times.
    Returns (last pass's recommendations, per-pass seconds, waves run in
    all, telemetry summary over the timed passes, the pass as a function)."""
    svc = svc_cls(kappa=16, iterations=10, cache_capacity=0, device=dev)
    svc.register_graph("g", g, formats=[26], engine=engine)

    def run():
        futs = [svc.submit(query_cls("g", v, k=10, precision=prec))
                for v, prec in queries]
        svc.flush()
        recs = [f.result() for f in futs]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return recs

    run()                                   # warm-up: builds, uploads, caches
    warm_waves = int(svc.telemetry_summary()["waves"])
    svc.telemetry.reset()
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        recs = run()
        times.append(time.perf_counter() - t0)
    summary = svc.telemetry_summary()
    return recs, times, warm_waves + int(summary["waves"]), summary, run


def _host_ms_per_iteration(run):
    """Host milliseconds a served ``fused_ppr_iteration`` call takes (Python,
    operand checks, allocations, ctypes, two launches; no synchronise), over
    one pass of ``run``."""
    from repro_torch.ppr_serving.engine import fused as fused_engine

    kernel, spent = fused_engine.fused_ppr_iteration, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = kernel(*a, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    fused_engine.fused_ppr_iteration = timed
    try:
        run()
    finally:
        fused_engine.fused_ppr_iteration = kernel
    return statistics.median(spent) * 1e3, sum(spent) * 1e3, len(spent)


def _busy_profile(torch, run, passes=3, tries=3):
    """Device-busy share of ``passes`` served passes under ``torch.profiler``:
    the union of device-event intervals over the window of the passes, and
    device time by kernel name.  A profile that delivers no device event is
    profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("served_passes"):
                for _ in range(passes):
                    run()
        events = prof.events()
        if any(_on_device(torch, e) and e.name != "served_passes" for e in events):
            break
    win = [e for e in events if e.name == "served_passes"
           and e.device_type != torch.autograd.DeviceType.CUDA][0].time_range
    device = [e for e in events if _on_device(torch, e) and e.name != "served_passes"]
    dev_iv = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for e in device:
        by_name[_short(e.name)] = (by_name.get(_short(e.name), 0.0)
                                   + (e.time_range.end - e.time_range.start))
    for a, b in dev_iv:
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = win.end - win.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(passes=passes, window_ms=window / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=(busy / window) if window else None,
                device_events=len(dev_iv),
                device_ms_by_name={k: v / 1e3 for k, v in top})


def service_phase(torch, np, g, dev, n_fixed=64, n_float=32, passes=10):
    from repro_torch.graphs import ppr_reference
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ppr_serving import PPRQuery, PPRService

    rng = np.random.default_rng(2020)
    verts = rng.choice(g.num_vertices, n_fixed + n_float, replace=False)
    queries = ([(int(v), 26) for v in verts[:n_fixed]]
               + [(int(v), None) for v in verts[n_fixed:]])
    reset_launch_counts()
    fused, t_fused, waves_run, s_fused, run_fused = _serve(
        torch, PPRService, PPRQuery, g, "fused", queries, dev, passes)
    counts = launch_counts()
    waves = int(s_fused["waves"])           # over the timed passes
    if counts["fused_ppr_iteration"] == 0:
        _fail("the served path launched fused_ppr_iteration no time")
    host_p50_ms, host_total_ms, host_calls = _host_ms_per_iteration(run_fused)
    busy = _busy_profile(torch, run_fused)
    if not busy["device_events"]:
        _fail("torch.profiler saw no device event in the served passes")
    single, t_single, _, s_single, _ = _serve(
        torch, PPRService, PPRQuery, g, "single", queries, dev, passes)
    float_err, float_vert_agree = 0.0, 0
    for rf, rs in zip(fused, single):
        if rf.precision != rs.precision:
            _fail("precision keys differ between engines")
        if rf.precision != "f32":
            if not (np.array_equal(rf.vertices, rs.vertices)
                    and np.array_equal(rf.scores, rs.scores)):
                _fail(f"fixed recommendation for vertex {rf.query.vertex} "
                      f"differs between fused and single")
        else:
            float_err = max(float_err, float(np.abs(rf.scores - rs.scores).max()))
            float_vert_agree += int(np.array_equal(rf.vertices, rs.vertices))
        if not np.all(np.isfinite(rf.scores)) or rf.vertices.shape != (10,):
            _fail("a recommendation is not 10 finite scores")
        if rf.query.vertex in set(rf.vertices.tolist()):
            _fail("a query vertex recommended itself")
    if float_err > 1e-6:
        _fail(f"float scores differ by {float_err} between fused and single")
    # top-10 overlap with the scipy float64 oracle for 8 queries
    pers = np.asarray([v for v, _ in queries[:4]] + [v for v, _ in queries[-4:]])
    ref = ppr_reference(g, pers, alpha=ALPHA, iterations=100)
    overlaps = []
    for j, v in enumerate(pers):
        col = ref[:, j].copy()
        col[v] = -np.inf
        top = set(np.argsort(-col, kind="stable")[:10].tolist())
        rec = fused[j] if j < 4 else fused[len(fused) - 8 + j]
        overlaps.append(len(top & set(rec.vertices.tolist())))
    def rates(times, n):                     # all over all time, and per pass
        per = [n / t for t in times]
        return n * len(times) / sum(times), min(per), max(per)

    fq, fq_lo, fq_hi = rates(t_fused, len(queries))
    sq, sq_lo, sq_hi = rates(t_single, len(queries))
    out = dict(queries_per_pass=len(queries), passes=passes,
               waves=waves, fused_pass_s=t_fused, single_pass_s=t_single,
               fused_queries_per_s=fq, fused_queries_per_s_pass_range=[fq_lo, fq_hi],
               fused_waves_per_s=waves / sum(t_fused),
               single_queries_per_s=sq, single_queries_per_s_pass_range=[sq_lo, sq_hi],
               single_waves_per_s=int(s_single["waves"]) / sum(t_single),
               fused_wave_latency_p50_s=s_fused["wave_latency_p50_s"],
               single_wave_latency_p50_s=s_single["wave_latency_p50_s"],
               fused_wave_latency_p95_s=s_fused["wave_latency_p95_s"],
               single_wave_latency_p95_s=s_single["wave_latency_p95_s"],
               launches=counts, launches_per_wave={
                   k: v / waves_run for k, v in counts.items()},
               host_ms_per_iteration_p50=host_p50_ms,
               host_ms_iterations_per_pass=host_total_ms, iterations_per_pass=host_calls,
               fused_profile=busy,
               float_max_score_diff=float_err,
               float_vertex_lists_equal=float_vert_agree,
               oracle_top10_overlap=overlaps)
    print(f"[service] gnp_2e5: {passes} timed passes of {len(queries)} queries "
          f"({waves} waves) per engine; "
          f"fixed recommendations identical; float max score diff {float_err:.3e}; "
          f"float lists equal {float_vert_agree}/{n_float}")
    print(f"[service] fused launches during the phase: {counts}; per wave: "
          f"fused_ppr_iteration {counts['fused_ppr_iteration'] / waves_run:g}, "
          f"fused_ppr_dangling_mass {counts['fused_ppr_dangling_mass'] / waves_run:g} "
          f"(folded into fused_ppr_iteration's kernel A)")
    print(f"[service] fused host time per fused_ppr_iteration call: p50 "
          f"{host_p50_ms:.4f} ms ({host_calls} calls, {host_total_ms:.2f} ms of a pass)")
    print(f"[service] fused profile over {busy['passes']} passes: window "
          f"{busy['window_ms']:.2f} ms, device busy {busy['device_busy_ms']:.2f} ms "
          f"({100 * busy['device_busy_share']:.1f}%), {busy['device_events']} device "
          f"events; by name {json.dumps(busy['device_ms_by_name'])}")
    print(f"[service] top-10 overlap with scipy float64 oracle (4 Q1.25, 4 f32): "
          f"{overlaps}")
    return out


# ---------------------------------------------------------------------------
# phase 4: early exit
# ---------------------------------------------------------------------------
def early_exit_phase(torch, np, g, dev, budgets=(40, 120), bits=20):
    """Fused vs single under ``early_exit``: identical states and iteration
    counts at each budget (the service at the first).  At 40 iterations Q1.19
    on pl_2e5 has not reached its absorbing state yet; the longer budget
    exercises the exit itself."""
    from repro_torch.autotune import ConvergencePolicy
    from repro_torch.core.fixed_point import format_for_bits
    from repro_torch.ppr_serving import PPRQuery, PPRService, get_engine
    from repro_torch.ppr_serving.engine.fused import FusedRegisteredGraph
    from repro_torch.ppr_serving.graphs import RegisteredGraph

    fmt = format_for_bits(bits)
    pol = ConvergencePolicy()
    pers = torch.as_tensor(np.random.default_rng(7).choice(g.num_vertices, K,
                                                           replace=False), device=dev)
    graphs = {"fixed": RegisteredGraph("g", g, device=dev),
              "fused_fixed": FusedRegisteredGraph("g", g, v_tile=V_TILE, device=dev)}
    out = []
    for budget in budgets:
        results = {}
        for key, rg in graphs.items():
            plan = get_engine(key).plan(rg, fmt, alpha=ALPHA, iterations=budget,
                                        convergence=pol)
            Vmat = plan.initial(pers)
            results[key] = plan.iterate(lambda P_: plan.step(Vmat, P_), Vmat)
        (p_s, it_s), (p_f, it_f) = results["fixed"], results["fused_fixed"]
        if it_s != it_f:
            _fail(f"early exit after {it_f} (fused) vs {it_s} (single) iterations")
        if not torch.equal(p_s, p_f):
            _fail("early-exit states differ between fused and single")
        print(f"[early-exit] pl_2e5 {fmt.name} budget {budget}: fused and single "
              f"both stop after {it_f} iterations with identical states")
        out.append(dict(budget=budget, iterations_run=it_f, format=fmt.name))
    recs = {}
    for engine in ("single", "fused"):
        svc = PPRService(kappa=16, iterations=budgets[0], early_exit=True,
                         cache_capacity=0, device=dev)
        svc.register_graph("g", g, formats=[bits], engine=engine)
        recs[engine] = svc.run_batch([PPRQuery("g", int(v), k=10, precision=bits)
                                      for v in pers.tolist()])
    for a, b in zip(recs["single"], recs["fused"]):
        if not (np.array_equal(a.vertices, b.vertices)
                and np.array_equal(a.scores, b.scores)):
            _fail("early-exit recommendations differ between fused and single")
    print(f"[early-exit] service budget {budgets[0]}: identical recommendations")
    return out


# ---------------------------------------------------------------------------
# phase 5: the SpMV path
# ---------------------------------------------------------------------------
def spmv_path_phase(torch, np, g, dev):
    from repro_torch.core import BlockedCOO, Q1_25, spmv_fixed, spmv_float, spmv_kernel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import pad_p_for_blocks

    blocked = BlockedCOO.build(g, v_tile=V_TILE, packet=PACKET)
    v = g.num_vertices
    x = torch.as_tensor(g.x, device=dev)
    y = torch.as_tensor(g.y, device=dev)
    outs = {}
    reset_launch_counts()
    for fmt in (None, Q1_25):
        p_np, _ = _inputs(np, g, fmt, seed=11)
        p = torch.as_tensor(p_np, device=dev)
        outs[fmt] = (p, spmv_kernel(blocked, pad_p_for_blocks(p, blocked), fmt=fmt)[:v])
    counts = launch_counts()
    if counts["coo_spmv"] == 0:
        _fail("the SpMV path launched coo_spmv no time")
    p, out = outs[None]
    ref = spmv_float(x, y, torch.as_tensor(g.val, device=dev), p, v)
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-8):
        _fail("spmv_kernel f32 differs from spmv_float")
    p, out = outs[Q1_25]
    ref = spmv_fixed(x, y, torch.as_tensor(g.quantized_val(Q1_25).view(np.int32),
                                           device=dev), p, v, Q1_25)
    if not torch.equal(out, ref):
        _fail("spmv_kernel Q1.25 differs from spmv_fixed")
    print(f"[spmv] gnp_2e5 spmv_kernel matches spmv_float/spmv_fixed; "
          f"launches {counts['coo_spmv']}")
    return counts


# ---------------------------------------------------------------------------
# phase 6: the LM kernels at gemma-2b's shapes
# ---------------------------------------------------------------------------
# kernel vs plain: float32 to rtol = atol = 1e-4 (both float32, sums in other
# orders); bf16 attention to one bf16 ulp, rtol 2^-7 with atol 1e-3 near 0
# (both compute in float32 from the same bf16 inputs and round the output to
# bf16 once, so the two may land one ulp apart); the matmul's output is f32
F32_TOL = dict(rtol=1e-4, atol=1e-4)
LM_TOL = {"flash_attention": {"f32": F32_TOL, "bf16": dict(rtol=2 ** -7, atol=1e-3)},
          "quantized_matmul": {"f32": F32_TOL, "bf16": F32_TOL}}
ATTN_CASES = [  # name, B, S, H, KV, d, causal, window
    ("gemma-2b", 2, 4096, 8, 1, 256, True, 0),
    ("gemma3-4b-window", 2, 4096, 8, 4, 256, True, 1024),
]
MM_CASES = [  # name, M, K, N  (gemma-2b: w_gate/w_up [2048, 16384], w_down [16384, 2048])
    ("w_gate-M128", 128, 2048, 16384), ("w_down-M128", 128, 16384, 2048),
    ("w_gate-M4096", 4096, 2048, 16384), ("w_down-M4096", 4096, 16384, 2048),
]


def _valid_pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head over S positions."""
    if not causal:
        return s * s if window <= 0 else sum(min(s, i + window) for i in range(s))
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _check_close(torch, name, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        _fail(f"{name}: kernel differs from its plain version, max abs err {err} "
              f"(rtol {tol['rtol']}, atol {tol['atol']})")
    return err


def lm_ops_per_call(torch, dev):
    """Device operations one call of each LM kernel wrapper runs, counted by
    ``torch.profiler`` on small inputs before the other phases (one launch
    each whatever the shape)."""
    from repro_torch.core.quantization import quantize_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_gqa

    gen = torch.Generator(dev).manual_seed(5)
    q = torch.randn((1, 128, 4, 64), generator=gen, device=dev)
    kv = torch.randn((1, 128, 1, 64), generator=gen, device=dev)
    a = torch.randn((128, 128), generator=gen, device=dev)
    qw = quantize_weights(torch.randn((128, 128), generator=gen, device=dev))
    return {"flash_attention": _device_ops(
                torch, lambda: flash_attention_gqa(q, kv, kv, causal=True))[0],
            "quantized_matmul": _device_ops(
                torch, lambda: ops.quantized_matmul(a, qw.q, qw.scale))[0]}


def lm_kernel_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.core.quantization import quantize_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.fixed_matmul import quantized_matmul_plain
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_gqa_plain)

    gen = torch.Generator(dev).manual_seed(6)
    rows = []
    for name, b, s, h, kv, d, causal, window in ATTN_CASES:
        for dom, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
            k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dt)
            v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dt)
            kw = dict(causal=causal, window=window)
            got = flash_attention_gqa(q, k, v, **kw)
            want = flash_attention_gqa_plain(q, k, v, **kw)
            err = _check_close(torch, f"flash_attention {name} {dom}", got, want,
                               LM_TOL["flash_attention"][dom])
            del want
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window:
                pos = torch.arange(s, device=dev)
                mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
                lib_kw = dict(attn_mask=mask)
            else:
                lib_kw = dict(is_causal=True)

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw)

            lib_diff = float((library().transpose(1, 2).float() - got.float()).abs().max())
            es = q.element_size()
            bound, by = _roofline(2 * q.numel() * es + 2 * k.numel() * es,
                                  4 * d * b * h * _valid_pairs(s, causal, window), dom)
            rows.append(dict(
                kernel="flash_attention", case=name, domain=dom, max_abs_err=err,

                shape=dict(B=b, S=s, H=h, KV=kv, d=d, causal=causal, window=window),
                ms=_time_ms(torch, lambda: flash_attention_gqa(q, k, v, **kw)),
                plain_ms=_time_ms(torch, lambda: flash_attention_gqa_plain(q, k, v, **kw),
                                  repeats=5),
                library_ms=_time_ms(torch, library), library="F.scaled_dot_product_attention",
                library_max_abs_diff=lib_diff, bound_ms=bound, bound_by=by))
            del q, k, v, got
    for name, m, kdim, n in MM_CASES:
        w = torch.randn((kdim, n), generator=gen, device=dev) / kdim ** 0.5
        qw = quantize_weights(w)
        del w
        for dom, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            a = torch.randn((m, kdim), generator=gen, device=dev).to(dt)
            got = ops.quantized_matmul(a, qw.q, qw.scale)
            want = quantized_matmul_plain(a, qw.q, qw.scale)
            err = _check_close(torch, f"quantized_matmul {name} {dom}", got, want,
                               LM_TOL["quantized_matmul"][dom])
            bound, by = _roofline(a.numel() * a.element_size() + kdim * n + n * 4 + m * n * 4,
                                  2 * m * kdim * n, dom)
            rows.append(dict(
                kernel="quantized_matmul", case=name, domain=dom, max_abs_err=err,

                shape=dict(M=m, K=kdim, N=n),
                ms=_time_ms(torch, lambda: ops.quantized_matmul(a, qw.q, qw.scale)),
                plain_ms=_time_ms(torch, lambda: quantized_matmul_plain(a, qw.q, qw.scale)),
                library_ms=_time_ms(torch, lambda: (a @ qw.q.to(a.dtype)) * qw.scale),
                library="(a @ w_q.to(a.dtype)) * scale", bound_ms=bound, bound_by=by))
            del a, got, want
    torch.cuda.empty_cache()
    for r in rows:
        print(f"[lm-kernels] {r['kernel']} {r['case']} {r['domain']}: ms {r['ms']:.4f} "
              f"plain {r['plain_ms']:.4f} library {r['library_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) max abs err {r['max_abs_err']:.3e}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: gemma-2b served at full width
# ---------------------------------------------------------------------------
LOGIT_TOL = dict(rtol=2e-3, atol=2e-4)   # the reference's decode-vs-forward tolerance
# (d): a serving shape — a full wave of 1,024-token prompts, 128 new tokens each
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_PASSES = 32, 1024, 128, 3


def _greedy(torch, api, params, prompt, n_new, max_len):
    """Per-request greedy decode; returns (tokens, top-2 logit gap per step)."""
    cache = api.init_cache(1, max_len)
    logits, cache = api.prefill(params, {"tokens": prompt[None]}, cache)
    toks, gaps, pos = [], [], prompt.shape[0]
    for _ in range(n_new):
        top2 = torch.topk(logits[0], 2).values
        toks.append(int(logits[0].argmax()))
        gaps.append(float(top2[0] - top2[1]))
        logits, cache = api.decode_step(params, torch.tensor([[toks[-1]]]), pos, cache)
        pos += 1
    return toks, gaps


def lm_serving_phase(torch, np, dev, passes=5):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quantization import quantize_weights
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.models import build_model
    from repro_torch.models.attention import _attend, _project_qkv
    from repro_torch.models.common import act_fn, norm
    from repro_torch.models.moe import mlp
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("gemma-2b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    api32 = build_model(cfg32, device=dev)
    t0 = time.perf_counter()
    params = api32.init_params(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[lm] gemma-2b: {cfg.num_layers} layers, {n_params} parameters "
          f"(cfg.param_count() {cfg.param_count()}), "
          f"{n_params * 4 / 1e9:.2f} GB float32, drawn in {init_s:.2f} s")
    out = dict(layers=cfg.num_layers, parameters=n_params, init_s=init_s)
    rng = np.random.default_rng(12)

    # (a) float32: decode == forward, engine == per-request greedy
    b, s = 2, 16
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    full = api32.forward(params, {"tokens": toks})
    cache = api32.init_cache(b, 64)
    lp, cache = api32.prefill(params, {"tokens": toks[:, :s]}, cache)
    ld, cache = api32.decode_step(params, toks[:, s:], s, cache)
    errs = [float((lp - full[:, s - 1]).abs().max()), float((ld - full[:, s]).abs().max())]
    if not (torch.allclose(lp, full[:, s - 1], **LOGIT_TOL)
            and torch.allclose(ld, full[:, s], **LOGIT_TOL)):
        _fail(f"gemma-2b f32: prefill/decode logits differ from forward by {errs} "
              f"(rtol {LOGIT_TOL['rtol']}, atol {LOGIT_TOL['atol']})")
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for _ in range(3)]
    served = ServingEngine(api32, params, batch_size=3, max_len=64).serve(
        [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    min_gap = float("inf")
    for i, p in enumerate(prompts):
        manual, gaps = _greedy(torch, api32, params, p, 5, 64)
        min_gap = min(min_gap, min(gaps))
        for t, (x, y) in enumerate(zip(served[i], manual)):
            if x != y:
                print(f"[lm] request {i} step {t}: engine {x} vs greedy {y}, "
                      f"top-2 logit gap {gaps[t]:.3e}")
                if gaps[t] > LOGIT_TOL["atol"]:
                    _fail("ServingEngine tokens differ from per-request greedy")
                break     # a tie within the logit tolerance; later tokens may differ
    print(f"[lm] (a) f32: prefill/decode vs forward max abs err {errs[0]:.3e}/"
          f"{errs[1]:.3e}; engine == per-request greedy (smallest top-2 gap "
          f"{min_gap:.3e})")
    out.update(decode_vs_forward_max_abs_err=errs, greedy_min_top2_gap=min_gap)
    del full, cache

    # (b): layer 0 of a B=2, S=2048 prefill through the kernels
    s = 2048
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, s)), device=dev)
    layer = params.layers[0]
    x = norm(params.embed_tokens(toks, cfg32), layer["ln1"], cfg32.norm)
    q, k, v = _project_qkv(x, layer["attn"], cfg32, torch.arange(s, device=dev)[None])
    pos = torch.arange(s, device=dev)
    ref = _attend(q, k, v, pos, pos, cfg32, causal=True)
    qw = {n: quantize_weights(layer["mlp"][n]) for n in ("w_gate", "w_up", "w_down")}
    x2 = x.reshape(-1, cfg.d_model)
    reset_launch_counts()
    att = flash_attention_gqa(q, k, v, causal=True)

    def qmm(a, n):
        return ops.quantized_matmul(a, qw[n].q, qw[n].scale)

    m = qmm(act_fn(qmm(x2, "w_gate"), cfg32.act) * qmm(x2, "w_up"), "w_down")
    torch.cuda.synchronize()
    path_counts = launch_counts()
    for name in ("flash_attention", "quantized_matmul"):
        if path_counts[name] == 0:
            _fail(f"the LM path launched {name} no time")
    att_err = float((att - ref).abs().max())
    if not torch.allclose(att, ref, rtol=2e-4, atol=2e-4):
        _fail(f"flash_attention_gqa differs from the model's _attend on gemma-2b "
              f"layer 0: max abs err {att_err} (rtol = atol = 2e-4)")
    m_ref = mlp(x, layer["mlp"], cfg32).reshape(-1, cfg.d_model)
    mlp_rel = float((m - m_ref).norm() / m_ref.norm())
    if not (torch.isfinite(m).all() and mlp_rel < 0.1):
        _fail(f"int8 MLP of layer 0 is {mlp_rel:.3e} (relative L2) from the f32 MLP")
    print(f"[lm] (b) layer 0, B=2 S=2048: flash_attention_gqa vs _attend max abs err "
          f"{att_err:.3e}; int8 MLP vs f32 MLP relative L2 {mlp_rel:.3e} "
          f"(truncating per-channel int8); path launches {path_counts}")
    out.update(attend_max_abs_err=att_err, int8_mlp_rel_l2=mlp_rel, launches=path_counts)
    del x, q, k, v, ref, att, m, m_ref, qw, x2
    torch.cuda.empty_cache()

    # (c) bfloat16: launch/serve.py's defaults, timed (a smoke reading: at 96
    # tokens a pass the host's dispatch sets the rate)
    api16 = build_model(cfg, device=dev)
    prefill_ms, decode_ms = [], []

    def timed(fn, sink):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return r
        return run

    api_t = api16._replace(prefill=timed(api16.prefill, prefill_ms),
                           decode_step=timed(api16.decode_step, decode_ms))
    engine = ServingEngine(api_t, params, batch_size=4, max_len=128)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                    max_new_tokens=8) for i in range(12)]
    engine.serve(reqs)                                  # warm-up
    prefill_ms.clear()
    decode_ms.clear()
    times, n_tok = [], 0
    for _ in range(passes):
        t = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        n_tok = sum(len(r) for r in res.values())
        if n_tok != 96 or not all(0 <= x < cfg.padded_vocab for r in res.values() for x in r):
            _fail("bf16 serving did not return 8 in-vocabulary tokens per request")
    per = [n_tok / t for t in times]
    out.update(bf16_tokens_per_s=n_tok * passes / sum(times),
               bf16_tokens_per_s_pass_range=[min(per), max(per)],
               bf16_pass_s=times, prefill_ms_p50=statistics.median(prefill_ms),
               decode_step_ms_p50=float(np.percentile(decode_ms, 50)),
               decode_step_ms_p95=float(np.percentile(decode_ms, 95)),
               prefill_calls=len(prefill_ms), decode_steps=len(decode_ms),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[lm] (c) bf16 serve (smoke reading): 12 requests, batch 4, prompt 16, 8 new tokens, "
          f"{passes} timed passes: {out['bf16_tokens_per_s']:.1f} tokens/s (passes "
          f"{min(per):.1f}-{max(per):.1f}); prefill p50 {out['prefill_ms_p50']:.2f} ms "
          f"(B=4, S=16); decode step p50/p95 {out['decode_step_ms_p50']:.2f}/"
          f"{out['decode_step_ms_p95']:.2f} ms; peak memory {out['peak_mem_gb']:.2f} GB")
    del engine

    # (d) bfloat16 at a serving shape: one wave of SERVE_BATCH requests with
    # SERVE_PROMPT-token prompts and SERVE_NEW new tokens each, timed
    b, s, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prefill_ms.clear()
    decode_ms.clear()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(api_t, params, batch_size=b, max_len=s + n_new)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, s).astype(np.int32),
                    max_new_tokens=n_new) for i in range(b)]
    engine.serve([dataclasses.replace(r, max_new_tokens=4) for r in reqs])  # warm-up
    prefill_ms.clear()
    decode_ms.clear()
    times = []
    for _ in range(SERVE_PASSES):
        t = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if (sum(len(r) for r in res.values()) != b * n_new
                or not all(0 <= x < cfg.padded_vocab for r in res.values() for x in r)):
            _fail(f"bf16 serving at B={b} did not return {n_new} in-vocabulary "
                  f"tokens per request")
    per = [b * n_new / t for t in times]
    out["serving_shape"] = dict(
        batch=b, prompt=s, new_tokens=n_new, max_len=s + n_new, passes=SERVE_PASSES,
        tokens_per_s=b * n_new * SERVE_PASSES / sum(times),
        tokens_per_s_pass_range=[min(per), max(per)], pass_s=times,
        prefill_ms=prefill_ms[:], decode_step_ms_p50=float(np.percentile(decode_ms, 50)),
        decode_step_ms_p95=float(np.percentile(decode_ms, 95)),
        decode_steps=len(decode_ms), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    sv = out["serving_shape"]
    print(f"[lm] (d) bf16 serve at a serving shape: {b} requests, batch {b}, prompt {s}, "
          f"{n_new} new tokens, {SERVE_PASSES} timed passes: {sv['tokens_per_s']:.1f} "
          f"tokens/s (passes {min(per):.1f}-{max(per):.1f}); prefill (B={b}, S={s}) "
          f"{statistics.median(prefill_ms):.2f} ms p50; decode step p50/p95 "
          f"{sv['decode_step_ms_p50']:.2f}/{sv['decode_step_ms_p95']:.2f} ms; "
          f"peak memory {sv['peak_mem_gb']:.2f} GB")
    del engine, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build

    card = _card_line()
    dev = torch.device("cuda")
    # float32 products in full float32 for every comparison (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} in {build_s:.2f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    lm_ops = lm_ops_per_call(torch, dev)
    print(f"[device-ops] one call each: {lm_ops}")
    t0 = time.perf_counter()
    graphs = _graphs()
    print(f"[graphs] generated in {time.perf_counter() - t0:.1f} s")
    rows, streams = kernel_phase(torch, np, graphs, dev, timing=True)
    service = service_phase(torch, np, graphs["gnp_2e5"], dev)
    early = early_exit_phase(torch, np, graphs["pl_2e5"], dev)
    spmv_counts = spmv_path_phase(torch, np, graphs["gnp_2e5"], dev)
    lm_rows = lm_kernel_phase(torch, dev)
    lm = lm_serving_phase(torch, np, dev)

    print("[times] kernel graph domain: ms plain_ms bound_ms library_ms "
          "function_bound_ms bound_share | device_ms device_bound_share "
          "library_device_ms | device_ops_per_call (profiles) device_ms_by_kernel")

    def opt(x):
        return "null" if x is None else f"{x:.4f}"

    for r in rows:
        print(f"[times] {r['kernel']} {r['graph']} {r['domain']}: {r['ms']:.4f} "
              f"{r['plain_ms']:.4f} {r['bound_ms']:.4f} {opt(r['library_ms'])} "
              f"{r['unpadded_bound_ms']:.4f} {r['bound_ms'] / r['ms']:.4f} | "
              f"{r['device_ms']:.4f} {r['bound_ms'] / r['device_ms']:.4f} "
              f"{opt(r['library_device_ms'])} | {r['device_ops_per_call']} "
              f"({r['device_ops_profiles']}) "
              f"{json.dumps({k: round(t, 5) for k, t in r['device_ms_by_kernel'].items()})}")
    sv = service
    print(f"[times] service gnp_2e5 over {sv['passes']} passes: fused "
          f"{sv['fused_queries_per_s']:.1f} queries/s (passes "
          f"{sv['fused_queries_per_s_pass_range'][0]:.1f}-"
          f"{sv['fused_queries_per_s_pass_range'][1]:.1f}), "
          f"{sv['fused_waves_per_s']:.2f} waves/s; single "
          f"{sv['single_queries_per_s']:.1f} queries/s (passes "
          f"{sv['single_queries_per_s_pass_range'][0]:.1f}-"
          f"{sv['single_queries_per_s_pass_range'][1]:.1f}), "
          f"{sv['single_waves_per_s']:.2f} waves/s; wave latency p50/p95 fused "
          f"{sv['fused_wave_latency_p50_s'] * 1e3:.2f}/"
          f"{sv['fused_wave_latency_p95_s'] * 1e3:.2f} ms, single "
          f"{sv['single_wave_latency_p50_s'] * 1e3:.2f}/"
          f"{sv['single_wave_latency_p95_s'] * 1e3:.2f} ms")

    launches = dict(service["launches"], coo_spmv=spmv_counts["coo_spmv"])
    sources = {"coo_spmv": ("src/repro_torch/csrc/coo_spmv.cu",
                            "src/repro/kernels/coo_spmv.py:125"),
               "fused_ppr_iteration": ("src/repro_torch/csrc/fused_ppr.cu",
                                       "src/repro/kernels/fused_ppr.py:404"),
               "fused_ppr_dangling_mass": ("src/repro_torch/csrc/fused_ppr.cu",
                                           "src/repro/kernels/fused_ppr.py:365")}
    launches_source = {
        "coo_spmv": "phase 5: core.spmv.spmv_kernel",
        "fused_ppr_iteration": "phase 3: PPRService served path",
        "fused_ppr_dangling_mass": "phase 3: PPRService served path, where the "
                                   "dangling fold runs inside fused_ppr_iteration's "
                                   "kernel A and this standalone launch is not made"}
    kernels = []
    for r in rows:
        src, repl = sources[r["kernel"]]
        suffix = "" if r["graph"] == "gnp_2e5" else f",{r['graph']}"
        kernels.append(dict(
            name=f"{r['kernel']}[{r['domain']}{suffix}]", route="cuda", source=src,
            replaces=repl, launches=launches[r["kernel"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
            function_bound_ms=r["unpadded_bound_ms"],
            device_ops_per_call=r["device_ops_per_call"], device_ms=r["device_ms"],
            library_device_ms=r["library_device_ms"],
            launches_source=launches_source[r["kernel"]], parity="pass"))
    lm_sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                      "src/repro/kernels/flash_attention.py:86"),
                  "quantized_matmul": ("src/repro_torch/csrc/fixed_matmul.cu",
                                       "src/repro/kernels/fixed_matmul.py:42")}
    for r in lm_rows:
        src, repl = lm_sources[r["kernel"]]
        kernels.append(dict(
            name=f"{r['kernel']}[{r['domain']},{r['case']}]", route="cuda", source=src,
            replaces=repl, launches=lm["launches"][r["kernel"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            device_ops_per_call=lm_ops[r["kernel"]],
            launches_source="phase 7(b): gemma-2b layer-0 attention and int8 MLP "
                            "through the kernels' entry points, composed by this script",
            parity="pass"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, streams=streams, kernel_rows=rows, service=service,
        early_exit=early,
        lm_kernel_rows=lm_rows, lm_serving=lm, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
