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
   then the top-K selection kernel on [V, 16] states at gnp_2e5's and
   paper_1m's V (k = 10, one vertex excluded a column) against its plain
   version, the stable sort, and its times beside one ``torch.topk``; and
   at k = 200, four passes of the kernel;
3. the served path: ``PPRService(kappa=16, iterations=10, device="cuda")``
   on ``gnp_2e5`` with ``engine="fused"`` and ``engine="single"``, 64 queries
   at precision 26 and 32 in float32 each, compared with each other and with
   the scipy float64 oracle; the fused kernels' launch counts over the run
   (``topk_select`` once a wave, in either family);
   the host time of a served ``fused_ppr_iteration`` call, and the device's
   busy share of three fused passes under ``torch.profiler``;
4. early exit on ``pl_2e5`` (``early_exit``, Q1.19, budgets 40 and 120):
   fused and single return identical states after identical iteration counts;
   4b. live edge deltas on ``gnp_2e5`` (a fused and a single service, ten
   ``random_delta(n_add=1024, n_remove=512)``, one ``localized_delta`` and
   one growth of 256 vertices): after each, the refreshed dst stream equals
   a fresh build, kernel 2 on it equals its plain version, and 32 served
   queries equal a fresh registration's and the single family's; the
   ``apply_delta`` ms and its stages, the reports, and device memory across
   the deltas; then warm start on ``pl_2e5`` (Q1.19, budget 120) after a
   delta that removes a hub edge: cold and warm iteration counts;
5. the SpMV path (``core.spmv.spmv_kernel``) with its launch count, and the
   times: CUDA-event medians of one call of each kernel as a caller that
   waits sees it (``ms``, the host's enqueue included, as every earlier
   version of this script measured), of its plain version and of one library
   call where PyTorch has one; beside them ``device_ms``, the same calls
   with the host's enqueue hidden behind a queued sleep; the least time the
   card could take (bytes over 3.35 TB/s), the device operations one call
   runs (``torch.profiler``), and the service's waves/s and queries/s;
6. the tensor-core report of the two LM kernel libraries (ptxas'
   registers, shared memory and spills of every kernel; the HGMMA count of
   each kernel's SASS where the toolkit has ``cuobjdump``: a bf16 kernel
   without one, or a spilling head_dim-256 attention kernel, fails); then
   the LM kernels against their plain versions at gemma-2b's shapes:
   ``flash_attention_gqa`` (B=2, S=4096, d=256; H=8/KV=1 causal, and
   H=8/KV=4 with gemma3-4b's window of 1024) and ``quantized_matmul``
   (M of 128 and 4096 against gemma-2b's w_gate/w_up and w_down, with the
   K split each shape gets), each in float32 and bfloat16, with kernel
   (``ms`` and ``device_ms``), plain and library times and the bound (bytes
   over 3.35 TB/s or FLOPs over the type's peak, the larger);
7. gemma-2b served at full width (18 layers, 2.51 B float32 master
   parameters drawn on the card from seed 0): (a) in float32, decode equals
   forward and ``ServingEngine`` equals per-request greedy decoding; (b)
   layer 0's q/k/v of a B=2, S=2048 prefill through the model's ``_attend``
   and through ``flash_attention_gqa``, and its MLP through
   ``quantized_matmul``; then the same layer in bfloat16 through the
   tensor-core kernels, each call held to its plain version (the launches
   counted over both passes are the kernels' path launches); (c) in
   bfloat16, ``launch/serve.py``'s defaults timed over several passes (a
   smoke reading of a host-bound loop): tokens/s, prefill ms, decode-step
   ms p50/p95; (d) the same at a serving shape: one wave of 32 requests,
   1,024-token prompts, 128 new tokens each;
8. autotune, prefetch and the driver, after phase 4b: (a) 24 waves of 16
   ``precision="auto"`` queries (``AutotuneConfig()``: ladder 20/22/24/26,
   target 0.95, a quarter sampled from seed 0; a hot set of 16 and a cold
   pool) on gnp_2e5 and pl_2e5 through a fused and a single service: the
   same resolved precisions, promotions and demotions, raw-bit equal fixed
   answers, float answers within 1e-6, shadow scores within 1e-4, and the
   fused service's kernel launches split into waves and shadow references;
   the auto wave's p50 against explicit waves at the resolved format, the
   shadow cost a sample (float reference, host copy, ranking + NDCG) and
   each graph's rung; the unreachable ladder (8,) demoting to f32 and then
   serving through the fused float kernel; (b) prefetch on the fused
   family: an idle poll warms the hot set, a warmed hit equals a fresh
   computation, a poll with κ queued is suppressed, a delta queues the
   dropped hot vertices for re-warming; (c) ``repro_torch.launch.ppr_run``
   on gnp_2e5 at full size, its default, ``--serve`` and
   ``--replay-deltas`` modes on the card and the default on the CPU, each
   a subprocess that exits 0, with equal accuracy blocks and each mode's
   req/s;
9. tracing, SLO, OTLP and the HTTP tier, after phase 8: (c) first,
   ``fused_ppr_iteration`` at K = 32 and 64 (the κ the admission controller
   deepens to) on both graphs against its plain version (Q1.25 raw bits;
   float32 at phase 2's limits to the plain version in float64), timed;
   (a) phase 3's traffic through three fused services on gnp_2e5
   (untraced, ``tracing=True``, ``tracing=0.1``), without and with
   ``early_exit``: equal answers and iteration counts, five spans and the
   iterate attributes on every kept wave trace, the seeded sampled share,
   and each service's wave p50 and span p50s; (b) ``PPRHTTPServer`` on
   127.0.0.1 over a fused service (κ = 16, ``early_exit``, ``tracing=0.1``,
   ``slo=True``, an ``OTLPExporter`` to an in-process collector): 512 POSTs
   at concurrency 64 (Q1.25, f32, auto), then two bursts under a tight
   admission config with the pump held back (κ → 32, then κ → 64 and 111
   shed); every 200 equals ``run_batch`` on an untraced fused service at
   the precision it names, no 500, the endpoints answer 200, the waves run
   on the pump's worker thread on the main thread's stream, and the
   collector holds exactly the exporter's spans; requests/s, client
   p50/p99, waves and occupancy; (d) ``ppr_run --http 0 --trace --slo
   --otlp-endpoint`` (16 POSTs, ``/v1/slo``, SIGINT: exit 0, 0 failed
   sends) and ``ppr_run --serve --dump-traces 3`` as subprocesses;
10. mesh-sharded serving, after phase 9 (``launch.mesh.make_mesh``: on a
   one-card host every shard sits on ``cuda:0``, so no copy crosses cards):
   (a) ``coo_spmv_kernel`` over every shard stream of gnp_2e5 and pl_2e5 at
   S = 3, 4, 8, K = 16, f32 and Q1.25, each against its plain version
   (Q1.25 raw bits; f32 at phase 2's limits to the plain version in
   float64), the gathered rows against the whole graph's plain SpMV, each
   shard's device ms beside its byte bound, and a zero-edge shard over
   memory left full of ones; (b) phase 3's traffic through a 4-shard meshed
   ``PPRService``, a fused and a single one on both graphs: Q1.25 raw-equal
   to both, f32 within 1e-6 of the fused family's, the oracle's top-10
   overlaps equal, ``waves_mesh:shardx4``, the meshed and fused passes
   timed in turns (wave p50, queries/s) and a meshed pass's host time split
   into per-shard calls, gather, dangling mass and combine; (c) early exit
   on pl_2e5 (Q1.19, budget 120): the same iterations and states as fused;
   (d) a ``random_delta(1024, 512)`` and a growth of 256 vertices on the
   meshed gnp_2e5: buckets, streams and answers equal a fresh
   registration's, ``apply_delta`` ms; (e) 8 ``precision="auto"`` waves of
   16 on the mesh against a fused service: precisions, controller, answers
   and shadow scores equal, each shadow reference through
   ``sharded_float``; (f) ``PPR_PAPER_1M`` (2^20 vertices, 2^24 edges) on
   the mesh against the fused family at its default on the same graph:
   states and top-K raw-equal, wave p50 each, stream bytes; (g) ``ppr_run
   --serve --shards 4`` as a subprocess, its count lines equal to phase
   8's ``--serve``;
11. the LM families at full width, after phase 7 (float32 masters drawn
   on the card from seed 0; mixtral-8x7b and moonshot-v1-16b-a3b cut to 8
   layers, gemma3-4b, mamba2-1.3b and zamba2-1.2b whole): in float32, (1)
   at B = 1 decode against forward (MoE without capacity drops, routes
   pinned to forward's at float32 gate ties), (2) gemma3-4b's rolling
   window cache against the full one over a prompt of 1,536 and 16 steps,
   with both caches' bytes, (3) layer 0's MoE on its real inputs at
   capacity factors 1.25 and 0.5: the card's routing and COO dispatch
   against the CPU's, moe_ffn against float64, the dropped entries, (4)
   ``ssd_chunked`` at mamba2's layer width against a float64 recurrence,
   (5) ``ServingEngine`` against per-request greedy; then bf16 serving of
   8 requests in one wave, 64 new tokens each: tokens/s, prefill ms,
   decode-step ms p50/p95 over 2 timed passes, the busy share of a
   profiled pass, peak memory, and gemma3-4b's decode step with rolling
   buffers;
12. whisper-medium and phi-3-vision-4.2b, and the training path, after
   phase 11: (a) both models whole (float32 masters drawn on the card from
   seed 0): in float32 at B = 1, prefill against forward over the same 64
   tokens with the frames or 576 patches, 4 decode steps against forward
   (rtol 2e-3 / atol 2e-4), whisper's cross cache against the encoder
   output's wk / wv; then bf16 serving: whisper 8 requests with frames [8,
   1500, 1024] through a greedy prefill / decode loop, phi-3-vision 8 text
   requests through ``ServingEngine`` and one wave with patches through
   ``prefill``, 64 new tokens each: tokens/s, prefill ms, decode-step p50 /
   p95, the busy share of a profiled pass, peak memory; (b) gemma-2b at full
   width cut to 2 layers, float32, B = 2, S = 64 from ``synthetic_batch``:
   the card's loss and every gradient leaf against the CPU's, and the
   parameters after one AdamW step, at rtol 2e-4 / atol 2e-5 (where Adam's
   direction is ill-conditioned, √v̂ < 1e-6, within 2.5·lr); remat on against
   off; 2 microbatches against 1; the residuals of 12-bit compression ≤
   2^-12; (c) ``python -m repro_torch.launch.train`` as a subprocess at its
   defaults (batch 8, seq 256, bf16, remat): gemma-2b 20 steps, again with
   ``--microbatches 2 --compress-bits 12``, and whisper-medium 10 steps:
   step ms p50, tokens/s, first and last loss (finite), peak memory and the
   busy share of a profiled step; (d) ``run_resumable`` at smoke size on the
   card, a failure at step 4 and a resume, against an uninterrupted run;
13. the sharding rules, the compressed all-reduce, the H100 roofline and
   the dry-run drivers, after phase 12, in at most 60 s: (a) gemma-2b at
   full width cut to 2 layers, float32, phase 12(b)'s seed and batch, its
   parameters as DTensors by ``distributed.sharding``'s rules on a 1×1 mesh
   of a one-rank NCCL group under ``set_sharding_context``: the loss, every
   gradient leaf and the parameters after one AdamW step against the same
   step unsharded (rtol 2e-4 / atol 2e-5, the max difference printed);
   ``compressed_psum`` over the group at 12 bits equal to
   ``truncate_to_grid`` with residual g + r − q bit for bit; a save of the
   stepped parameters and restore(shardings=) onto the mesh bit for bit;
   (b) ``structured_roofline`` (a one-rank "fake" group, meta tensors) of
   gemma-2b's train step at phase 12(c)'s shape and decode step at phase
   7(d)'s, its terms beside the p50s measured there and the share of the
   bound each reaches (printed, not gated; the gate: counted train FLOPs
   within [1.0, 1.5] × 6·N·T); (c) ``launch.ppr_dryrun --workload
   ppr-pod-16m`` and ``launch.dryrun --arch gemma-2b --shape decode_32k
   --mesh single`` as subprocesses, exit 0 and the reference's JSON keys;
14. the examples on the card, after phase 13, in at most 90 s: the five
   scripts of ``examples_torch/`` as subprocesses with ``--device cuda``
   (the three PPR ones in turn, ``serve_lm.py`` and ``train_lm.py --steps
   60`` beside them), and ``quickstart.py``,
   ``ppr_recommender.py`` and ``http_serving.py`` with ``--device cpu``
   beside them: each exits 0; the card's PPR lines equal the CPU's with the
   clocks masked; the HTTP tier's ordinary traffic equals the CPU's and its
   burst answers all 32, sheds and recovers (the burst's split and the
   audit, which depend on how fast a wave drains the queue, printed beside
   the CPU's); serve_lm's 10 requests give 60 tokens; train_lm's last loss
   is below its first and no checkpoint is written; ``[examples]`` lines
   with each run's wall seconds.  They launch none of the four kernels
   (the examples' "single" family and eager models);
15. a ``{"kernels": [...]}`` JSON line, then the card line, then the
   ``{"ok": true, ...}`` line last.

Everything too long for the end of the output goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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
# the card's rates, set in main() from repro_torch.roofline.analysis, so that the
# kernel table's bounds and the dry run share one set of constants (H100 SXM
# data sheet: HBM3 3.35e12 B/s; 67e12 FLOP/s float32 on the CUDA cores, 989e12
# bf16 dense on the tensor cores)
HBM_BYTES_PER_S = None
PEAK_FLOPS = None
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


def _load_constants() -> None:
    global HBM_BYTES_PER_S, PEAK_FLOPS
    from repro_torch.roofline import analysis

    HBM_BYTES_PER_S = analysis.HBM_BW
    PEAK_FLOPS = {"f32": analysis.PEAK_FLOPS_F32, "bf16": analysis.PEAK_FLOPS}


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
def _inputs(np, g, fmt, seed, k=K):
    """A state P [V, k] and V̄ [V, k] from a seed, in the domain of ``fmt``."""
    rng = np.random.default_rng(seed)
    v = g.num_vertices
    pers = rng.choice(v, k, replace=False)
    p = (rng.random((v, k)) * (2.0 / v)).astype(np.float32)
    p[pers, np.arange(k)] += 0.15
    vm = np.zeros((v, k), np.float32)
    vm[pers, np.arange(k)] = 1.0
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


def _check_float_p_next(torch, what, pn_k, pn_p) -> float:
    """float32 P_next of the kernel against its plain version: rtol 1e-5 +
    atol 1e-9 and 1e-6 absolutely.  Returns the max abs error."""
    err = float((pn_k - pn_p).abs().max()) if pn_k.numel() else 0.0
    if err > 1e-6 or not torch.allclose(pn_k, pn_p, rtol=1e-5, atol=1e-9):
        _fail(f"{what}: P_next max abs err {err} "
              f"(limits: rtol 1e-5 + atol 1e-9, and 1e-6)")
    return err


def _check_fused_iteration(torch, what, fargs, fmt) -> float:
    """One ``fused_ppr_iteration`` on the card against its plain version on
    the same operands; returns P_next's max abs error.  Limits: float32
    P_next as ``_check_float_p_next``, L1/Σd² residuals rtol 1e-4, ∞
    residual 1e-6; fixed point raw bits equal, ∞ residual equal."""
    from repro_torch.kernels.fused_ppr import fused_ppr_iteration, fused_ppr_plain

    fkw = dict(alpha=ALPHA, fmt=fmt)
    pn_k, res_k = fused_ppr_iteration(*fargs, **fkw)
    pn_p, res_p = fused_ppr_plain(*fargs, **fkw)
    if fmt is None:
        err = _check_float_p_next(torch, what, pn_k, pn_p)
        for r in (0, 2):
            if not torch.allclose(res_k[r], res_p[r], rtol=1e-4, atol=0.0):
                _fail(f"{what}: residual row {r} {res_k[r]} vs {res_p[r]}")
        if float((res_k[1] - res_p[1]).abs().max()) > 1e-6:
            _fail(f"{what}: inf residual {res_k[1]} vs {res_p[1]}")
        return err
    if not torch.equal(pn_k, pn_p):
        _fail(f"{what}: P_next raw bits differ")
    if not torch.equal(res_k[1], res_p[1]):
        _fail(f"{what}: inf residual differs")
    for r in (0, 2):
        if not torch.allclose(res_k[r], res_p[r], rtol=1e-4, atol=0.0):
            _fail(f"{what}: residual row {r}")
    return 0.0


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
            err = _check_fused_iteration(torch, f"fused {gname} {dom}", fargs, fmt)
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


TOPK_SHAPES = {"gnp_2e5": 200_000, "paper_1m": 1 << 20}   # [V, K] states, K = 16
TOPK_K = 10                                                 # the cells' k
TOPK_DEEP = 200                                             # a k of four passes


def topk_phase(torch, np, dev):
    """Phase 2's last part: the top-K selection kernel
    (``kernels/topk_select.py``) on a PPR-scale state [V, 16] at gnp_2e5's
    and paper_1m's V, in float32 and Q1.25, k = 10 with each column's
    personalization vertex excluded (as a served wave asks): ids and score
    bits equal to the plain version (the stable sort the port ran before,
    here on the card), then its times beside the plain version's and one
    ``torch.topk`` of the same keys (a yardstick of time only: its ties fall
    in no promised order).  Then k = 200, which the kernel selects in four
    passes of at most KMAX, held to the plain version and timed the same
    way (``deep_ms``, ``deep_device_ms``)."""
    from types import SimpleNamespace

    from repro_torch.core.fixed_point import Q1_25
    from repro_torch.kernels.topk_select import topk_select, topk_select_plain

    rows = []
    for gname, v in TOPK_SHAPES.items():
        for fmt in (None, Q1_25):
            dom = "f32" if fmt is None else fmt.name
            p_np, vm_np = _inputs(np, SimpleNamespace(num_vertices=v), fmt, seed=v % 97)
            p = torch.as_tensor(p_np, device=dev)
            pers = torch.as_tensor(np.argmax(vm_np, axis=0).astype(np.int32), device=dev)
            got = topk_select(p, TOPK_K, exclude=pers)
            want = topk_select_plain(p, TOPK_K, exclude=pers)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                _fail(f"topk_select {gname} {dom}: differs from the plain version")
            nbytes = v * K * 4 + K * TOPK_K * 8
            row = dict(kernel="topk_select", graph=gname, domain=dom, max_abs_err=0.0,
                       bound_ms=_bound_ms(nbytes), unpadded_bound_ms=_bound_ms(nbytes))
            _timings(torch, row, lambda: topk_select(p, TOPK_K, exclude=pers),
                     lambda: topk_select_plain(p, TOPK_K, exclude=pers),
                     plain_repeats=REPEATS)
            _library_timings(torch, row, lambda: torch.topk(p, TOPK_K + 1, dim=0))
            got = topk_select(p, TOPK_DEEP, exclude=pers)
            want = topk_select_plain(p, TOPK_DEEP, exclude=pers)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                _fail(f"topk_select {gname} {dom} k={TOPK_DEEP}: differs from the plain "
                      f"version")
            row["deep_k"] = TOPK_DEEP
            row["deep_ms"] = _time_ms(torch, lambda: topk_select(p, TOPK_DEEP, exclude=pers))
            row["deep_device_ms"] = _time_ms(
                torch, lambda: topk_select(p, TOPK_DEEP, exclude=pers), hide_host=True)
            rows.append(row)
            print(f"[topk] {gname} {dom} [{v}, {K}] k={TOPK_K}: kernel = plain; "
                  f"{row['ms']:.4f} ms a call, device {row['device_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / row['device_ms']:.1f}% "
                  f"of device), plain {row['plain_ms']:.4f} ms, torch.topk "
                  f"{row['library_ms']:.4f} ms (device {row['library_device_ms']:.4f}), "
                  f"{row['device_ops_per_call']} device ops a call "
                  f"{json.dumps({k: round(t, 5) for k, t in row['device_ms_by_kernel'].items()})}; "
                  f"k={TOPK_DEEP} = plain, {row['deep_ms']:.4f} ms a call, device "
                  f"{row['deep_device_ms']:.4f} ms")
            del p, pers, got, want
    return rows


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


def _replay_host_ms(run):
    """``run()``'s result, the host ms of each replayed fixed-budget wave
    (span ``ppr.wave.replay``: the copies into the captured chain's inputs,
    the graph launch and the output's clone; no synchronize) and of each
    eager ``fused_ppr_iteration`` call (span ``ppr.step``) over the call,
    from the port's span timeline."""
    from repro_torch.obs import trace

    tl = trace.arm_timeline(1 << 16)
    try:
        result = run()
    finally:
        trace.disarm_timeline()
    out = {"ppr.wave.replay": [], "ppr.step": []}
    for i in range(tl.n):
        name = trace.TIMELINE_SPANS[tl.name[i]]
        if name in out:
            out[name].append((tl.end[i] - tl.start[i]) / 1e6)
    return result, out["ppr.wave.replay"], out["ppr.step"]


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
    if counts["topk_select"] != waves_run:
        _fail(f"the fused family's {waves_run} waves launched topk_select "
              f"{counts['topk_select']} times (one a wave)")
    _, replay_ms, step_ms = _replay_host_ms(run_fused)
    if not replay_ms or step_ms:
        _fail(f"a warm fused pass replayed {len(replay_ms)} waves and made "
              f"{len(step_ms)} eager fused_ppr_iteration calls (every wave replays)")
    busy = _busy_profile(torch, run_fused)
    if not busy["device_events"]:
        _fail("torch.profiler saw no device event in the served passes")
    reset_launch_counts()
    single, t_single, single_waves_run, s_single, _ = _serve(
        torch, PPRService, PPRQuery, g, "single", queries, dev, passes)
    if launch_counts()["topk_select"] != single_waves_run:
        _fail(f"the single family's {single_waves_run} waves launched topk_select "
              f"{launch_counts()['topk_select']} times (one a wave)")
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
               host_ms_per_replayed_wave_p50=statistics.median(replay_ms),
               replayed_waves_per_pass=len(replay_ms),
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
    print(f"[service] fused host time per replayed wave (copies, graph launch, "
          f"clone): p50 {statistics.median(replay_ms):.4f} ms ({len(replay_ms)} waves "
          f"a pass, no eager fused_ppr_iteration call)")
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
# phase 4b: live edge deltas and warm start
# ---------------------------------------------------------------------------
DELTA_FIELDS = ("row_ptr", "col", "nz_rows", "slice_row")


def _serve_batch(svc, query_cls, queries):
    """Submit every (vertex, precision) query, flush, and return the
    recommendations in order (pending futures of the service resolve too)."""
    futs = [svc.submit(query_cls("g", v, k=10, precision=prec)) for v, prec in queries]
    svc.flush()
    return [f.result() for f in futs]


def _same_answers(np, what, got, want, float_tol=1e-6):
    """Q1.25 answers raw-bit equal (vertices and scores); float32 scores
    within ``float_tol``.  Returns the float lists whose vertices agree."""
    agree = 0
    for a, b in zip(got, want):
        if a.precision != b.precision or a.query.vertex != b.query.vertex:
            _fail(f"{what}: answers out of step")
        if not (np.all(np.isfinite(a.scores)) and a.vertices.shape == (10,)):
            _fail(f"{what}: a recommendation is not 10 finite scores")
        if a.query.vertex in set(a.vertices.tolist()):
            _fail(f"{what}: a query vertex recommended itself")
        if a.precision != "f32":
            if not (np.array_equal(a.vertices, b.vertices)
                    and np.array_equal(a.scores, b.scores)):
                _fail(f"{what}: {a.precision} answer for vertex {a.query.vertex} differs")
        else:
            err = float(np.abs(a.scores - b.scores).max())
            if err > float_tol:
                _fail(f"{what}: float scores for vertex {a.query.vertex} differ by {err}")
            agree += int(np.array_equal(a.vertices, b.vertices))
    return agree


def delta_phase(torch, np, graphs, dev):
    """gnp_2e5: twelve deltas on a fused and a single service, each followed
    by the refreshed stream against a fresh build, kernel 2 on it against its
    plain version, and 32 served queries against a fresh registration and
    the single family.  pl_2e5: warm start after a delta that removes a hub
    edge.  The launches of kernel 2 counted are those of the delta'd fused
    services' served waves (counts zeroed just before each serve and read
    just after), not the comparisons."""
    import gc

    from repro_torch.core.fixed_point import Q1_25, format_for_bits
    from repro_torch.graph_updates import localized_delta, random_delta
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ppr_serving import PPRQuery, PPRService

    launches = 0

    def served(svc, queries):
        nonlocal launches
        reset_launch_counts()
        recs = _serve_batch(svc, PPRQuery, queries)
        torch.cuda.synchronize()
        launches += launch_counts()["fused_ppr_iteration"]
        return recs

    # ---- gnp_2e5: twelve deltas --------------------------------------------
    g = graphs["gnp_2e5"]
    svcs = {}
    for engine in ("fused", "single"):
        svcs[engine] = PPRService(kappa=K, iterations=10, device=dev)
        svcs[engine].register_graph("g", g, formats=[26], engine=engine)
    rg = svcs["fused"].registered_graph("g")
    rng = np.random.default_rng(2021)
    warm = [(int(v), prec) for v in rng.choice(g.num_vertices, 16, replace=False)
            for prec in (26, None)]
    served(svcs["fused"], warm)                   # fills the caches
    _serve_batch(svcs["single"], PPRQuery, warm)
    seen = {v for v, _ in warm}
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    rows = []
    # (a) ten random_delta(n_add=1024, n_remove=512), seeds 0-9; (b) one
    # localized_delta(n_add=4, n_remove=1); (c) 256 new vertices, each wired
    # to one old vertex (391 → 392 blocks of 512: a full rebuild); each drawn
    # against the graph as it stands
    for kind, seed in [("a", s) for s in range(10)] + [("b", 10), ("c", 11)]:
        before = rg.source
        rng = np.random.default_rng(seed)
        delta = (localized_delta(before, rng, n_add=4, n_remove=1) if kind == "b" else
                 random_delta(before, rng, n_add=0, n_remove=0, grow=256) if kind == "c"
                 else random_delta(before, rng, n_add=1024, n_remove=512))
        frontier = delta.affected_frontier(before)
        fr = set(frontier.tolist())
        outside = np.setdiff1d(np.arange(before.num_vertices), frontier)
        pick = np.random.default_rng(100 + seed)
        inside_new = [int(v) for v in pick.permutation(frontier) if int(v) not in seen][:8]
        outside_new = [int(v) for v in pick.permutation(outside) if int(v) not in seen][:8]
        # four pending queries a service: two in the frontier, two outside
        pend = [(inside_new.pop(), 26), (outside_new.pop(), 26),
                (inside_new.pop(), None), (outside_new.pop(), None)]
        pending = {e: [svc.submit(PPRQuery("g", v, k=10, precision=p)) for v, p in pend]
                   for e, svc in svcs.items()}
        reports = {}
        for engine, svc in svcs.items():
            reports[engine] = svc.apply_delta("g", delta)
            if engine == "fused":
                torch.cuda.synchronize()
                stages = dict(rg.delta_timings)
                dirty = rg.last_refresh_blocks
        apply_s = reports["fused"].pop("apply_s")
        reports["single"].pop("apply_s")
        if reports["fused"] != reports["single"]:
            _fail(f"delta {kind}{seed}: reports differ: {reports}")
        for engine, futs in pending.items():
            for f in futs:
                if (f.query.vertex in fr) != f.done():
                    _fail(f"delta {kind}{seed}: pending vertex {f.query.vertex} "
                          f"rejected {f.done()}, in the frontier {f.query.vertex in fr}")
                if f.done() and getattr(f.exception(), "code", None) != "delta-invalidated":
                    _fail(f"delta {kind}{seed}: rejection code {f.exception()!r}")
        # the refreshed stream against a fresh build of the merged graph
        fresh = PPRService(kappa=K, iterations=10, device=dev)
        frg = fresh.register_graph("g", rg.source, formats=[26], engine="fused")
        st, fst = rg.fused_stream(), frg.fused_stream()
        if st.slice_edges != fst.slice_edges or st.num_rows != fst.num_rows or not all(
                np.array_equal(getattr(st, f), getattr(fst, f)) for f in DELTA_FIELDS) \
                or not np.array_equal(st.val.view(np.uint32), fst.val.view(np.uint32)):
            _fail(f"delta {kind}{seed}: the refreshed dst stream differs from a fresh build")
        topo, ftopo = rg.fused_topology(), frg.fused_topology()
        if not all(torch.equal(getattr(topo, f), getattr(ftopo, f)) for f in DELTA_FIELDS):
            _fail(f"delta {kind}{seed}: the refreshed device stream differs")
        if not torch.equal(rg.fused_dangling(), frg.fused_dangling()):
            _fail(f"delta {kind}{seed}: the refreshed dangling list differs")
        # kernel 2 on the refreshed device stream against its plain version
        errs = {}
        for fmt in (None, Q1_25):
            if not torch.equal(rg.fused_values(fmt), frg.fused_values(fmt)):
                _fail(f"delta {kind}{seed}: refreshed values differ ({fmt})")
            p_np, vm_np = _inputs(np, rg.source, fmt, seed=seed)
            fargs = (topo, rg.fused_values(fmt), rg.fused_dangling(),
                     torch.as_tensor(vm_np, device=dev), torch.as_tensor(p_np, device=dev))
            errs["f32" if fmt is None else fmt.name] = _check_fused_iteration(
                torch, f"delta {kind}{seed} fused_ppr_iteration", fargs, fmt)
        del fargs
        # 16 Q1.25 + 16 f32 queries: the pending ones again, six more inside
        # the frontier and six outside (after (c), five and a vertex it added)
        outside_q = outside_new[:5] + [rg.num_vertices - 1] if kind == "c" \
            else outside_new[:6]
        verts = inside_new[:6] + outside_q + [v for v, _ in pend]
        if len(verts) != 16:
            _fail(f"delta {kind}{seed}: too few unseen vertices to query ({verts})")
        queries = [(v, 26) for v in verts] + [(v, None) for v in verts]
        seen.update(v for v, _ in queries)
        got = {"fused": served(svcs["fused"], queries),
               "single": _serve_batch(svcs["single"], PPRQuery, queries),
               "fresh": _serve_batch(fresh, PPRQuery, queries)}
        if any(r.source != "wave" for recs in got.values() for r in recs):
            _fail(f"delta {kind}{seed}: a post-delta answer came from the cache")
        agree = _same_answers(np, f"delta {kind}{seed} fused vs fresh", got["fused"], got["fresh"])
        _same_answers(np, f"delta {kind}{seed} fused vs single", got["fused"], got["single"])
        float_bits = all(np.array_equal(a.scores, b.scores)
                         for a, b in zip(got["fused"], got["fresh"]) if a.precision == "f32")
        del fresh, frg, fst, ftopo
        row = dict(kind=kind, seed=seed, apply_ms=apply_s * 1e3,
                   stages_ms={k: v * 1e3 for k, v in stages.items()},
                   dirty_blocks=dirty, edges=st.num_edges, slice_edges=st.slice_edges,
                   slices=st.num_slices, dangling=int(rg.fused_dangling().numel()),
                   max_abs_err=errs, float_lists_equal_fresh=agree,
                   float_bits_equal_fresh=float_bits, **reports["fused"])
        rows.append(row)
        print(f"[delta] gnp_2e5 {kind} seed {seed}: apply {row['apply_ms']:.1f} ms "
              f"({', '.join(f'{k} {v:.1f}' for k, v in row['stages_ms'].items())}); "
              f"dirty blocks {'all (full rebuild)' if dirty is None else dirty}; "
              f"|V|={row['num_vertices']} |E|={st.num_edges}, slices of {st.slice_edges}, "
              f"{int(row['dangling'])} dangling; frontier {row['frontier_size']}, "
              f"cache_dropped {row['cache_dropped']}, cache_retained "
              f"{row['cache_retained']}, pending_dropped {row['pending_dropped']}, "
              f"pending_requeued {row['pending_requeued']}; stream = fresh build, kernel "
              f"= plain, answers = fresh and single (float bit-equal {float_bits})")
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated(dev)
    topo = rg.fused_topology()
    one_stream = sum(t.numel() * t.element_size() for t in (
        topo.row_ptr, topo.col, topo.nz_rows, topo.slice_row, rg.fused_dangling(),
        rg.fused_values(None), rg.fused_values(Q1_25)))
    del topo
    print(f"[delta] device memory allocated before (a) {mem_before} B, after (c) "
          f"{mem_after} B: {mem_after - mem_before:+d} B against one stream with its "
          f"two formats, {one_stream} B")
    if mem_after - mem_before > one_stream:
        _fail("device memory grew by more than one stream across the deltas")
    a_ms = sorted(r["apply_ms"] for r in rows if r["kind"] == "a")
    stage_p50 = {k: statistics.median(r["stages_ms"][k] for r in rows if r["kind"] == "a")
                 for k in rows[0]["stages_ms"]}
    print(f"[delta] apply_delta over (a): p50 {statistics.median(a_ms):.1f} ms, max "
          f"{a_ms[-1]:.1f} ms; stage p50s {json.dumps({k: round(v, 2) for k, v in stage_p50.items()})}")
    del svcs, rg
    gc.collect()

    # ---- pl_2e5: warm start after a delta that removes a hub edge ------------
    g = graphs["pl_2e5"]
    bits, budget = 20, 120
    fmt = format_for_bits(bits)
    hub = int(np.bincount(g.x, minlength=g.num_vertices).argmax())
    seed = next(s for s in range(1000) if np.any(random_delta(
        g, np.random.default_rng(s), n_add=64, n_remove=32).remove_dst == hub))
    delta = random_delta(g, np.random.default_rng(seed), n_add=64, n_remove=32)
    frontier = delta.affected_frontier(g)
    pick = np.random.default_rng(7)
    outside = np.setdiff1d(np.arange(g.num_vertices), frontier)
    verts = [int(v) for v in pick.choice(frontier, 8, replace=False)] \
        + [int(v) for v in pick.choice(outside, 8, replace=False)]
    queries = [(v, bits) for v in verts]
    svcs, out = {}, {}
    for engine in ("fused", "single"):
        svc = PPRService(kappa=K, iterations=budget, early_exit=True, warm_start=True,
                         device=dev)
        svc.register_graph("g", g, formats=[bits], engine=engine)
        serve = served if engine == "fused" else (lambda s, q: _serve_batch(s, PPRQuery, q))
        serve(svc, queries)
        cold_iters = svc._cold_iters[("g", fmt.name)]
        report = svc.apply_delta("g", delta)
        saved0 = svc.telemetry_summary()["iterations_saved"]
        recs = serve(svc, queries)
        summ = svc.telemetry_summary()
        warm_iters = budget - int(summ["iterations_saved"] - saved0)
        svcs[engine] = svc
        out[engine] = dict(cold_iterations=cold_iters, warm_iterations=warm_iters,
                           warm_start_iterations_saved=summ["warm_start_iterations_saved"],
                           warm_start_columns=summ["warm_start_columns"],
                           frontier_size=report["frontier_size"],
                           cache_dropped=report["cache_dropped"],
                           waves=[r.source for r in recs].count("wave"), recs=recs)
    f, s_ = out["fused"], out["single"]
    for key in ("cold_iterations", "warm_iterations", "warm_start_iterations_saved"):
        if f[key] != s_[key]:
            _fail(f"warm start: {key} {f[key]} (fused) vs {s_[key]} (single)")
    _same_answers(np, "warm start fused vs single", f["recs"], s_["recs"])
    for v in verts:
        a = svcs["fused"]._warm.get("g", v, fmt.name)
        b = svcs["single"]._warm.get("g", v, fmt.name)
        if not np.array_equal(a, b):
            _fail(f"warm start: the fused and single states of vertex {v} differ")
    if not f["warm_start_iterations_saved"] > 0 or f["waves"] != 8:
        _fail(f"warm start saved no iteration or served {f['waves']} waves, not 8: {f}")
    # the warm waves (the frontier's 8) against a cold service on the merged
    # graph: rankings equal, scores within 4 resolution (a warm seed may
    # absorb into a state some LSBs away, tests/test_graph_updates.py:291-316);
    # a swap of two vertices whose cold scores lie within that tolerance is a
    # tie, not a ranking change.  The other 8 are served from the retagged
    # cache, as computed before the delta.
    merged = svcs["fused"].registered_graph("g").source
    cold = PPRService(kappa=K, iterations=budget, early_exit=True, warm_start=True,
                      device=dev)
    cold.register_graph("g", merged, formats=[bits], engine="fused")
    cold_recs = _serve_batch(cold, PPRQuery, queries[:8])
    tol = 4 * fmt.resolution
    exact, worst = 0, 0.0
    if [r.source for r in f["recs"][:8]] != ["wave"] * 8:
        _fail("warm start: a frontier vertex was not served by a wave")
    for w, c in zip(f["recs"][:8], cold_recs):
        worst = max(worst, float(np.abs(w.scores - c.scores).max()))
        col = cold._warm.get("g", w.query.vertex, fmt.name).astype(np.float64) / fmt.scale
        if np.abs(w.scores - c.scores).max() > tol or \
                np.abs(col[w.vertices] - c.scores).max() > tol:
            _fail(f"warm start: vertex {w.query.vertex} ranks {w.vertices} / {w.scores} "
                  f"against cold {c.vertices} / {c.scores}")
        exact += int(np.array_equal(w.vertices, c.vertices))
    print(f"[warm-start] pl_2e5 Q1.19 budget {budget}: delta seed {seed} removes an edge "
          f"into the hub {hub}; frontier {f['frontier_size']}, cache_dropped "
          f"{f['cache_dropped']}; cold wave {f['cold_iterations']} iterations, warm wave "
          f"{f['warm_iterations']} ({f['warm_start_columns']:.0f} seeded columns), "
          f"warm_start_iterations_saved {f['warm_start_iterations_saved']:.0f}; fused and "
          f"single identical; against a cold service: {exact}/8 lists equal, max score "
          f"diff {worst:.3e} (limit {tol:.3e})")
    for o in out.values():
        o.pop("recs")
    return dict(gnp_2e5=rows, apply_ms_p50=statistics.median(a_ms), apply_ms_max=a_ms[-1],
                stage_ms_p50=stage_p50, memory_before=mem_before, memory_after=mem_after,
                one_stream_bytes=one_stream, warm_start=dict(
                    out, hub=hub, delta_seed=seed, cold_lists_equal=exact,
                    cold_max_score_diff=worst), launches=launches)


# ---------------------------------------------------------------------------
# phase 8: autotune, prefetch and the driver
# ---------------------------------------------------------------------------
AUTO_WAVES = 24


def _auto_traffic(np, g, seed):
    """AUTO_WAVES waves of K vertices: half from a seeded hot set of K, half
    from a cold pool of 4K, drawn as ``ppr_run --replay-deltas`` draws its
    traffic."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, g.num_vertices, K)
    cold = rng.integers(0, g.num_vertices, 4 * K)
    return [[int(v) for v in np.concatenate([rng.choice(hot, K // 2),
                                             rng.choice(cold, K // 2)])]
            for _ in range(AUTO_WAVES)]


class _PlainCalls:
    """Counts calls of ``fused_ppr_plain`` (the kernel's plain version) while
    armed: on the card's served path there must be none."""

    def __init__(self):
        from repro_torch.kernels import fused_ppr as kfused
        self.module, self.inner, self.calls = kfused, kfused.fused_ppr_plain, 0

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            return self.inner(*a, **kw)
        self.module.fused_ppr_plain = counted
        return self

    def __exit__(self, *exc):
        self.module.fused_ppr_plain = self.inner


def _clock_shadow(torch, svc):
    """Wrap the parts of ``svc._shadow_feedback`` on the service's own path:
    per call that scored samples, (host ms, samples); the host ms of the
    float reference (``_float_reference``, to a synchronize: the device's
    time), of the host copies (``_sampled_to_host``) and of ranking + NDCG
    (``ranking`` and ``controller.observe_shadow``); and the
    fused_ppr_iteration launches the shadow references made.  The
    synchronize only moves the wait for the reference out of the first host
    copy into the reference's own span."""
    from repro_torch.kernels import fused_ppr_iteration
    from repro_torch.ppr_serving import service as service_mod

    stats = {"calls": [], "launches": 0, "reference_ms": 0.0, "host_copy_ms": 0.0,
             "ranking_ndcg_ms": 0.0}

    def clocked(part, inner, sync=False):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            stats[part] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    svc._float_reference = clocked("reference_ms", svc._float_reference, sync=True)
    svc._sampled_to_host = clocked("host_copy_ms", svc._sampled_to_host)
    svc.controller.observe_shadow = clocked("ranking_ndcg_ms", svc.controller.observe_shadow)
    rank = clocked("ranking_ndcg_ms", service_mod.ranking)
    inner = svc._shadow_feedback

    def timed(*a, **kw):
        n0 = svc.controller.estimator.shadow_evaluations
        l0 = fused_ppr_iteration.launches
        plain_rank, service_mod.ranking = service_mod.ranking, rank
        t0 = time.perf_counter()
        try:
            inner(*a, **kw)
        finally:
            service_mod.ranking = plain_rank
        dt = time.perf_counter() - t0
        stats["launches"] += fused_ppr_iteration.launches - l0
        n = svc.controller.estimator.shadow_evaluations - n0
        if n:
            stats["calls"].append((dt * 1e3, n))

    svc._shadow_feedback = timed
    return stats


def _timed_waves(torch, svc, query_cls, traffic, precision, target=None):
    """Serve each wave of ``traffic`` through ``run_batch``; (answers, host
    seconds a wave, the call ending on a synchronize)."""
    recs, secs = [], []
    for verts in traffic:
        t0 = time.perf_counter()
        recs.append(svc.run_batch([query_cls("g", v, k=10, precision=precision,
                                             quality_target=target) for v in verts]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return recs, secs


SHADOW_K = (1, 3, 4)     # sampled columns: K % 4 != 0 takes the one-wide template


def _check_shadow_shapes(torch, np, name, svc, verts):
    """``fused_ppr_iteration`` on the shadow reference's operands: the fused
    float plan's V over the first K of ``verts`` for each K in SHADOW_K, and
    each of its ten iterates as the reference chains them.

    P_next is held at phase 2's limits to the plain version evaluated in
    float64 on the same operands: the float32 plain version sums a row by
    atomics in no fixed order, and on pl_2e5's hub rows (18,187 in-edges)
    it lands up to ~8e-7 from the exact value, run to run, where the
    kernel's fixed-order sum stays within ~2e-8.  The residual rows are held
    at phase 2's limits (L1/Σd² rtol 1e-4, ∞ 1e-6) to those of the kernel's
    own P_next, in float64 from the same P: near convergence |P_next − P|
    shrinks to the plain version's error, so the two versions' Σd² rows
    drift apart.  Returns P_next's max abs error for each K; the largest
    distance of the float32 plain P_next from the float64 one; the residual
    rows' largest relative distance from the own-state rows; and the
    kernel's and the float32 plain Σd² rows' largest relative distance."""
    from repro_torch.kernels.fused_ppr import fused_ppr_iteration, fused_ppr_plain
    from repro_torch.ppr_serving import engine_for

    rg = svc.registered_graph("g")
    plan = engine_for("fused", False).plan(rg, None, alpha=ALPHA, iterations=10)
    topo, val, dang = rg.fused_topology(), rg.fused_values(None), rg.fused_dangling()
    val64 = val.double()
    errs, plain_err, own_rel, plain_rel = {}, 0.0, 0.0, 0.0

    def rel(a, b):
        return float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max())

    for k in SHADOW_K:
        vm = plan.initial(torch.as_tensor(np.asarray(verts[:k], np.int32), device=rg.device))
        p, err = vm, 0.0
        for it in range(10):
            what = f"shadow-shaped {name} K={k} iteration {it + 1}"
            pn, res = fused_ppr_iteration(topo, val, dang, vm, p, alpha=ALPHA, fmt=None)
            pn64, _ = fused_ppr_plain(topo, val64, dang, vm.double(), p.double(),
                                      alpha=ALPHA, fmt=None)
            pn_p, res_p = fused_ppr_plain(topo, val, dang, vm, p, alpha=ALPHA, fmt=None)
            err = max(err, _check_float_p_next(torch, what, pn.double(), pn64))
            plain_err = max(plain_err, float((pn_p.double() - pn64).abs().max()))
            d = (pn.double() - p.double()).abs()
            own = torch.stack([d.sum(0), d.amax(0), (d * d).sum(0)])
            for r in (0, 2):
                if not torch.allclose(res[r].double(), own[r], rtol=1e-4, atol=0.0):
                    _fail(f"{what}: residual row {r} {res[r]} vs its own P_next's {own[r]}")
            if float((res[1].double() - own[1]).abs().max()) > 1e-6:
                _fail(f"{what}: inf residual {res[1]} vs its own P_next's {own[1]}")
            own_rel = max(own_rel, rel(res[0], own[0]), rel(res[2], own[2]))
            plain_rel = max(plain_rel, rel(res[2], res_p[2]))
            p = pn
        errs[k] = err
    return dict(max_abs_err=errs, plain_f32_max_abs_err=plain_err,
                residual_vs_own_rel=own_rel, sumsq_vs_plain_rel=plain_rel)


def _near_ties(torch, np, services, verts):
    """The fused and the single family's float32 references for ``verts``
    (the shadow reference's shape) and the same ten iterations in float64
    (the fused family's plain version): each family's max abs distance from
    the float64 state and from each other, the rank positions at which the
    two rankings differ, and the largest gap (in the single family's scores)
    between neighbours of the single family's ranking that the fused one
    puts in the other order.  Served fixed-point states are bit-equal, so
    shadow scores differ between the families only through such swaps; an
    inverted gap no larger than the max abs difference makes each a
    near-tie.  Fails when the fused reference, the kernel's, lies more than
    1e-6 from the float64 state anywhere."""
    from repro_torch.core.metrics import ranking
    from repro_torch.kernels.fused_ppr import fused_ppr_plain
    from repro_torch.ppr_serving import engine_for

    refs = []
    for svc in services:
        rg = svc.registered_graph("g")
        plan = engine_for(rg.engine_family, False).plan(rg, None, alpha=ALPHA,
                                                       iterations=10)
        v0 = plan.initial(torch.as_tensor(np.asarray(verts, np.int32), device=rg.device))
        p = v0
        for _ in range(10):
            p = plan.step(v0, p)
        refs.append(p.cpu().numpy().astype(np.float64))
    rg = services[0].registered_graph("g")
    head = (rg.fused_topology(), rg.fused_values(None).double(), rg.fused_dangling())
    v64 = engine_for("fused", False).plan(rg, None, alpha=ALPHA, iterations=10).initial(
        torch.as_tensor(np.asarray(verts, np.int32), device=rg.device)).double()
    p64 = v64
    for _ in range(10):
        p64, _ = fused_ppr_plain(*head, v64, p64, alpha=ALPHA, fmt=None)
    exact = p64.cpu().numpy()
    rf, rs = refs
    fused_err = float(np.abs(rf - exact).max())
    if fused_err > 1e-6:
        _fail(f"fused float32 reference over {len(verts)} columns lies {fused_err} from "
              f"the float64 iterations (limit 1e-6)")
    moved, gap = 0, 0.0
    for j in range(len(verts)):
        order_s, order_f = ranking(rs[:, j]), ranking(rf[:, j])
        moved += int((order_s != order_f).sum())
        pos_f = np.empty_like(order_f)
        pos_f[order_f] = np.arange(order_f.size)
        inv = np.nonzero(pos_f[order_s[:-1]] > pos_f[order_s[1:]])[0]
        if inv.size:
            gap = max(gap, float((rs[order_s[inv], j] - rs[order_s[inv + 1], j]).max()))
    return dict(max_abs_diff=float(np.abs(rf - rs).max()), fused_vs_float64=fused_err,
                single_vs_float64=float(np.abs(rs - exact).max()),
                rank_positions_moved=moved, max_inverted_gap=gap)


def _auto_graph(torch, np, name, g, dev, card):
    """(a) on one graph: the same auto traffic through a fused and a single
    service with ``AutotuneConfig()``'s defaults, held to each other; then
    the same waves at the fused service's resolved format, explicitly."""
    from repro_torch.autotune import AutotuneConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ppr_serving import PPRQuery, PPRService

    traffic = _auto_traffic(np, g, seed=0)
    runs = {}
    for engine in ("fused", "single"):
        svc = PPRService(kappa=K, iterations=10, alpha=ALPHA, autotune=AutotuneConfig(),
                         cache_capacity=0, device=dev)
        svc.register_graph("g", g, engine=engine)
        shadow = _clock_shadow(torch, svc)
        with _PlainCalls() as plain:
            reset_launch_counts()
            recs, secs = _timed_waves(torch, svc, PPRQuery, traffic, "auto")
            launches = launch_counts()["fused_ppr_iteration"]
        runs[engine] = dict(svc=svc, recs=recs, secs=secs, shadow=shadow,
                            launches=launches, plain_calls=plain.calls)
    f, s = runs["fused"], runs["single"]
    fs, ss = f["svc"], s["svc"]
    for wf, ws in zip(f["recs"], s["recs"]):
        if [r.precision for r in wf] != [r.precision for r in ws]:
            _fail(f"auto {name}: resolved precisions differ between fused and single")
        _same_answers(np, f"auto {name} fused vs single", wf, ws)
    for key in ("promotions", "demotions"):
        if getattr(fs.controller, key) != getattr(ss.controller, key):
            _fail(f"auto {name}: {key} {getattr(fs.controller, key)} (fused) vs "
                  f"{getattr(ss.controller, key)} (single)")
    if fs.controller.summary() != ss.controller.summary():
        _fail(f"auto {name}: controllers differ: {fs.controller.summary()} vs "
              f"{ss.controller.summary()}")
    sf, sc = fs.telemetry.shadow_scores, ss.telemetry.shadow_scores
    if len(sf) != len(sc) or not sf:
        _fail(f"auto {name}: {len(sf)} shadow scores (fused) vs {len(sc)} (single)")
    score_diff = float(np.abs(np.asarray(sf) - np.asarray(sc)).max())
    if score_diff > 1e-4:
        _fail(f"auto {name}: shadow scores differ by {score_diff} (limit 1e-4)")
    wave_launches = f["launches"] - f["shadow"]["launches"]
    if wave_launches != AUTO_WAVES * 10 or f["shadow"]["launches"] <= 0 \
            or f["shadow"]["launches"] % 10:
        _fail(f"auto {name}: fused_ppr_iteration launches {f['launches']} (waves "
              f"{wave_launches}, shadow references {f['shadow']['launches']})")
    if f["plain_calls"] or s["launches"]:
        _fail(f"auto {name}: {f['plain_calls']} plain fused calls on the card, "
              f"{s['launches']} kernel launches by the single family")
    rung = fs.controller.rung_key("g")
    resolved = fs.controller.resolve("g")
    # the same waves at the resolved format, explicitly (no shadow): warm-up
    # wave first, so the format's upload is not timed
    precision = None if resolved is None else resolved.name
    explicit = PPRService(kappa=K, iterations=10, alpha=ALPHA, cache_capacity=0,
                          device=dev)
    explicit.register_graph("g", g, formats=[] if resolved is None else [resolved],
                            engine="fused")
    _timed_waves(torch, explicit, PPRQuery, traffic[:1], precision)
    explicit.telemetry.reset()
    _, x_secs = _timed_waves(torch, explicit, PPRQuery, traffic, precision)
    calls = f["shadow"]["calls"]
    samples = sum(n for _, n in calls)
    split = {part: f["shadow"][part] / samples
             for part in ("reference_ms", "host_copy_ms", "ranking_ndcg_ms")}
    shapes = _check_shadow_shapes(torch, np, name, fs, traffic[-1])
    ties = _near_ties(torch, np, (fs, ss), traffic[-1][:3])
    out = dict(
        graph=name, rung=rung, rung_bits=fs.controller.summary(),
        promotions=fs.controller.promotions, demotions=fs.controller.demotions,
        served_by_precision=dict(fs.telemetry.served_by_precision),
        shadow_samples=samples, shadow_calls=len(calls),
        shadow_score_max_diff=score_diff, shadow_quality_mean=float(np.mean(sf)),
        launches_fused=f["launches"], launches_waves=wave_launches,
        launches_shadow=f["shadow"]["launches"],
        auto_wave_ms_p50=statistics.median(f["secs"]) * 1e3,
        auto_wave_ms_p95=float(np.percentile(f["secs"], 95)) * 1e3,
        single_auto_wave_ms_p50=statistics.median(s["secs"]) * 1e3,
        explicit_wave_ms_p50=statistics.median(x_secs) * 1e3,
        auto_wave_latency_p50_ms=fs.telemetry_summary()["wave_latency_p50_s"] * 1e3,
        explicit_wave_latency_p50_ms=explicit.telemetry_summary()["wave_latency_p50_s"] * 1e3,
        shadow_ms_per_sample=sum(ms for ms, _ in calls) / samples,
        shadow_split_ms_per_sample=split, shadow_shapes=shapes,
        float_reference_near_ties=ties)
    print(f"[autotune] {name}: {AUTO_WAVES} waves of {K} auto queries, fused and single "
          f"identical (precisions, answers, controllers; shadow scores within "
          f"{score_diff:.2e}); rung {rung}, promotions {out['promotions']}, demotions "
          f"{out['demotions']}, served {out['served_by_precision']}; {samples} shadow "
          f"samples in {len(calls)} references; fused_ppr_iteration launches "
          f"{wave_launches} (waves) + {f['shadow']['launches']} (shadow references), "
          f"0 plain calls ({card})")
    print(f"[autotune] {name}: auto wave p50 {out['auto_wave_ms_p50']:.3f} ms (p95 "
          f"{out['auto_wave_ms_p95']:.3f}; single family {out['single_auto_wave_ms_p50']:.3f}) "
          f"against explicit {precision or 'f32'} wave p50 {out['explicit_wave_ms_p50']:.3f} "
          f"ms (run_batch of {K}, host clock to a synchronize); service wave latency "
          f"p50 {out['auto_wave_latency_p50_ms']:.3f} / {out['explicit_wave_latency_p50_ms']:.3f} "
          f"ms ({card})")
    print(f"[autotune] {name}: shadow cost {out['shadow_ms_per_sample']:.3f} ms a sample "
          f"in the service, of it: float reference {split['reference_ms']:.4f} ms "
          f"(host clock to a synchronize), host copy {split['host_copy_ms']:.4f} ms, "
          f"ranking + NDCG {split['ranking_ndcg_ms']:.3f} ms ({card})")
    print(f"[autotune] {name}: fused_ppr_iteration on the shadow reference's operands, "
          f"ten iterates each: P_next within "
          + ", ".join(f"K={k} {e:.2e}" for k, e in shapes["max_abs_err"].items())
          + f" of the plain version in float64 (phase 2's limits; the float32 plain "
          f"version's atomics: {shapes['plain_f32_max_abs_err']:.2e}); L1/Σd² rows within "
          f"{shapes['residual_vs_own_rel']:.2e} (relative) of its own P_next's; Σd² "
          f"{shapes['sumsq_vs_plain_rel']:.2e} (relative) from the float32 plain rows, "
          f"not held ({card})")
    print(f"[autotune] {name}: float32 references over 3 columns against ten float64 "
          f"iterations: fused {ties['fused_vs_float64']:.3e} (limit 1e-6), single "
          f"{ties['single_vs_float64']:.3e}; fused vs single {ties['max_abs_diff']:.3e}, "
          f"{ties['rank_positions_moved']} rank positions differ, largest inverted "
          f"neighbour gap {ties['max_inverted_gap']:.3e} (near-ties when at most the "
          f"max abs diff)")
    return out


def _unreachable_auto(torch, np, g, dev, card):
    """The unreachable ladder of tests/test_autotune.py:354-377 on gnp_2e5:
    Q1.7 misses 0.95, the first wave's feedback demotes to the f32 rung, and
    the next wave is served f32 through the fused float kernel."""
    from repro_torch.autotune import AutotuneConfig, ShadowConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ppr_serving import PPRQuery, PPRService

    cfg = AutotuneConfig(ladder=(8,), demote_patience=1,
                         shadow=ShadowConfig(sample_fraction=1.0, min_samples=1, window=2))
    svc = PPRService(kappa=K, iterations=10, alpha=ALPHA, autotune=cfg,
                     cache_capacity=0, device=dev)
    svc.register_graph("g", g, engine="fused")
    traffic = _auto_traffic(np, g, seed=1)[:2]
    launches = []
    with _PlainCalls() as plain:
        for verts in traffic:
            reset_launch_counts()
            _timed_waves(torch, svc, PPRQuery, [verts], "auto", target=0.95)
            launches.append(launch_counts()["fused_ppr_iteration"])
            if len(launches) == 1 and svc.controller.resolve("g", 0.95) is not None:
                _fail("unreachable target: the first wave's feedback did not demote to f32")
    served = dict(svc.telemetry.served_by_precision)
    summ = svc.telemetry_summary()
    if served != {"Q1.7": K, "f32": K} or svc.controller.demotions != 1 \
            or summ.get("engine_fused_float_waves") != 1 or launches != [20, 10] \
            or plain.calls:
        _fail(f"unreachable target: served {served}, demotions "
              f"{svc.controller.demotions}, fused float waves "
              f"{summ.get('engine_fused_float_waves')}, launches {launches}, "
              f"{plain.calls} plain calls")
    scores = svc.telemetry.shadow_scores
    print(f"[autotune] gnp_2e5 ladder (8,), target 0.95: wave 1 at Q1.7 (NDCG@50 mean "
          f"{np.mean(scores[:K]):.4f} over {K} samples) demoted to f32; wave 2 served f32 "
          f"by the fused float kernel ({launches[1]} launches; wave 1: {launches[0]}, "
          f"shadow reference included) ({card})")
    return dict(served=served, demotions=svc.controller.demotions, launches=launches,
                q17_ndcg_mean=float(np.mean(scores[:K])))


def _prefetch_fused(torch, np, g, dev, card):
    """(b) prefetch on the fused family: an idle poll warms the hot set, a
    later query is a cache hit bit-equal to a fresh computation, a poll with
    κ queued is suppressed, and a delta queues the dropped hot vertices for
    re-warming (then served from the re-warmed cache, bit-equal to a fresh
    registration of the merged graph)."""
    from repro_torch.graph_updates import random_delta
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ppr_serving import PPRQuery, PPRService, PrefetchConfig

    delta = random_delta(g, np.random.default_rng(31), n_add=1024, n_remove=512)
    frontier = delta.affected_frontier(g)
    outside = np.setdiff1d(np.arange(g.num_vertices), frontier)
    pick = np.random.default_rng(32)
    inside = [int(v) for v in pick.choice(frontier, K // 2, replace=False)]
    hot = inside + [int(v) for v in pick.choice(outside, K // 2, replace=False)]
    svc = PPRService(kappa=K, iterations=10, alpha=ALPHA, max_wait=60.0, device=dev,
                     prefetch=PrefetchConfig(top_n=K, k=10, max_per_pump=K, min_count=2))
    svc.register_graph("g", g, formats=[26], engine="fused")
    queries = [PPRQuery("g", v, k=10, precision=26) for v in hot]
    svc.run_batch(queries)
    svc.run_batch(queries)              # two real queries each: hot
    svc.cache.invalidate(lambda key: True)
    launches = 0

    def poll():
        nonlocal launches
        reset_launch_counts()
        t0 = time.perf_counter()
        waves = svc.poll()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches += launch_counts()["fused_ppr_iteration"]
        return waves, ms, launches

    with _PlainCalls() as plain:
        waves, warm_ms, n1 = poll()
        s = svc.telemetry_summary()
        if waves != 1 or s["prefetch_issued"] != K or n1 != 10:
            _fail(f"prefetch: the idle poll ran {waves} waves, issued "
                  f"{s['prefetch_issued']}, {n1} launches")

        def fresh_answers(graph, qs):
            fresh = PPRService(kappa=K, iterations=10, alpha=ALPHA, cache_capacity=0,
                               device=dev)
            fresh.register_graph("g", graph, formats=[26], engine="fused")
            return fresh.run_batch(qs)

        hit = svc.run_batch(queries[:1])
        if hit[0].source != "cache":
            _fail("prefetch: a warmed hot vertex was not served from the cache")
        _same_answers(np, "prefetch warmed hit vs fresh", hit, fresh_answers(g, queries[:1]))
        # κ live queries on two streams, neither full nor past its budget
        cold = [int(v) for v in outside if int(v) not in hot][:K]
        futs = [svc.submit(PPRQuery("g", v, k=10, precision=26 if i % 2 else None))
                for i, v in enumerate(cold)]
        waves, _, _ = poll()
        if waves or svc.telemetry_summary()["prefetch_suppressed"] != 1:
            _fail(f"prefetch: a poll with {K} queued ran {waves} waves, suppressed "
                  f"{svc.telemetry_summary()['prefetch_suppressed']}")
        svc.flush()
        if not all(f.done() for f in futs):
            _fail("prefetch: flush left a live query pending")
        report = svc.apply_delta("g", delta)
        queued = svc.telemetry_summary()["prefetch_rewarms_queued"]
        if queued != len(inside):
            _fail(f"prefetch: {queued} re-warms queued after the delta, expected "
                  f"{len(inside)} (the hot vertices in its frontier)")
        waves, rewarm_ms, _ = poll()
        rewarmed = svc.run_batch(queries[: len(inside)])
        if waves != 1 or any(r.source != "cache" for r in rewarmed):
            _fail("prefetch: the re-warm poll did not warm the dropped hot vertices")
        _same_answers(np, "prefetch re-warmed vs fresh on the merged graph", rewarmed,
                      fresh_answers(svc.registered_graph("g").source,
                                    queries[: len(inside)]))
    if plain.calls:
        _fail(f"prefetch: {plain.calls} plain fused calls on the card")
    s = svc.telemetry_summary()
    out = dict(prefetch_issued=s["prefetch_issued"], suppressed=s["prefetch_suppressed"],
               rewarms_queued=queued, frontier_size=report["frontier_size"],
               cache_dropped=report["cache_dropped"], warm_poll_ms=warm_ms,
               rewarm_poll_ms=rewarm_ms, launches=launches)
    print(f"[prefetch] gnp_2e5 fused: idle poll warmed {K} hot vertices in one wave "
          f"({warm_ms:.2f} ms); a warmed hit equals a fresh computation; a poll with "
          f"{K} queued was suppressed; a delta (frontier {report['frontier_size']}) "
          f"queued {queued} re-warms, served from the cache after one poll "
          f"({rewarm_ms:.2f} ms), equal to a fresh registration; {launches} "
          f"fused_ppr_iteration launches, 0 plain calls ({card})")
    return out


def _accuracy_block(stdout):
    lines = stdout.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith("accuracy vs CPU oracle"))
    return lines[at:at + 8]


def driver_phase(np, card, timeout=600):
    """(c) ``python -m repro_torch.launch.ppr_run`` on gnp_2e5 at the paper's
    size in its three modes on the card, and the default mode on the CPU;
    each a subprocess that must exit 0.  The accuracy blocks of the card's
    and the CPU's default runs must be equal to the printed digit."""
    import os
    import re

    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.launch.ppr_run", "--graph", "gnp_2e5",
            "--scale", "1.0", "--bits", "26", "--kappa", str(K)]
    modes = {"default": ["--requests", "64"],
             "serve": ["--requests", "64", "--serve"],
             "replay-deltas": ["--replay-deltas", "4", "--delta-edges", "1024"],
             "default-cpu": ["--requests", "64", "--device", "cpu"]}
    out = {}
    for mode, extra in modes.items():
        t0 = time.perf_counter()
        run = subprocess.run(base + extra, capture_output=True, text=True,
                             timeout=timeout, env=env, cwd=str(ROOT))
        wall = time.perf_counter() - t0
        if run.returncode:
            _fail(f"ppr_run {mode} exited {run.returncode}: {run.stderr[-2000:]}")
        if mode == "replay-deltas":
            served = re.findall(r"re-serve (\d+) q in ([\d.]+)s", run.stdout)
            rate = sum(int(q) for q, _ in served) / sum(float(s) for _, s in served)
        else:
            rate = float(re.search(r"\(([\d.]+) req/s", run.stdout).group(1))
        out[mode] = dict(req_per_s=rate, wall_s=wall, stdout=run.stdout)
    acc, acc_cpu = (_accuracy_block(out[m]["stdout"]) for m in ("default", "default-cpu"))
    if acc != acc_cpu:
        _fail(f"ppr_run: the card's accuracy block {acc} differs from the CPU's {acc_cpu}")
    for mode, r in out.items():
        where = "" if mode != "default-cpu" else " (the CPU: no device metric)"
        print(f"[driver] ppr_run {mode}: exit 0 in {r['wall_s']:.1f} s, "
              f"{r['req_per_s']:.1f} req/s{where} ({card})")
    print(f"[driver] accuracy block, card = CPU: {' | '.join(ln.strip() for ln in acc[1:])}")
    return out


def autotune_phase(torch, np, graphs, dev, card):
    """Phase 8: (a) auto on the fused family, (b) prefetch, (c) the driver.
    ``launches`` counts fused_ppr_iteration over the driven paths of (a)'s
    fused services (waves and shadow references), the unreachable-target
    waves and (b)'s polls."""
    t0 = time.perf_counter()
    auto = {name: _auto_graph(torch, np, name, g, dev, card) for name, g in graphs.items()}
    unreachable = _unreachable_auto(torch, np, graphs["gnp_2e5"], dev, card)
    prefetch = _prefetch_fused(torch, np, graphs["gnp_2e5"], dev, card)
    t1 = time.perf_counter()
    driver = driver_phase(np, card)
    launches = (sum(a["launches_fused"] for a in auto.values())
                + sum(unreachable["launches"]) + prefetch["launches"])
    print(f"[autotune] phase 8 took {time.perf_counter() - t0:.1f} s ((a)+(b) "
          f"{t1 - t0:.1f} s, the driver {time.perf_counter() - t1:.1f} s); "
          f"fused_ppr_iteration launches {launches}")
    return dict(auto=auto, unreachable=unreachable, prefetch=prefetch,
                driver={m: {k: v for k, v in r.items() if k != "stdout"}
                        for m, r in driver.items()},
                driver_stdout={m: r["stdout"] for m, r in driver.items()},
                launches=launches)


# ---------------------------------------------------------------------------
# phase 9: tracing, SLO, OTLP and the HTTP tier
# ---------------------------------------------------------------------------
DEEP_K = (32, 64)        # the κ the admission controller deepens to (kappa_max 64)
HTTP_REQUESTS, HTTP_CONCURRENCY = 512, 64
HTTP_TIMEOUT_S = 120.0   # a wave that fails leaves its clients waiting: fail instead


class _Collector:
    """An OTLP/HTTP collector on 127.0.0.1 (stdlib): counts the spans and
    the metric payloads POSTed to it."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        import threading

        self.spans = self.metric_posts = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                if self.path.endswith("/v1/traces"):
                    outer.spans += sum(len(ss["spans"]) for rs in body["resourceSpans"]
                                       for ss in rs["scopeSpans"])
                else:
                    outer.metric_posts += 1
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class _KernelCalls:
    """While armed, records each ``fused_ppr_iteration`` call the fused
    engine makes: its K, the calling thread, the current CUDA stream and
    the host ms of the call (no synchronize)."""

    def __init__(self, torch):
        from repro_torch.ppr_serving.engine import fused as fused_engine
        self.torch, self.module = torch, fused_engine
        self.inner, self.calls = fused_engine.fused_ppr_iteration, []

    def __enter__(self):
        import threading

        def recorded(*a, **kw):
            t0 = time.perf_counter()
            out = self.inner(*a, **kw)
            self.calls.append((int(a[4].shape[1]), threading.current_thread().name,
                               self.torch.cuda.current_stream().cuda_stream,
                               (time.perf_counter() - t0) * 1e3))
            return out
        self.module.fused_ppr_iteration = recorded
        return self

    def __exit__(self, *exc):
        self.module.fused_ppr_iteration = self.inner

    def by_k(self):
        out = {}
        for k, *_ in self.calls:
            out[k] = out.get(k, 0) + 1
        return dict(sorted(out.items()))


def _deep_kernel_rows(torch, np, graphs, dev):
    """(c) ``fused_ppr_iteration`` at K = 32 and 64 on both graphs against
    its plain version on the same operands: Q1.25 raw bits (P_next and the ∞
    row) equal; float32 P_next at phase 2's limits to the plain version run
    in float64 (the float32 plain version's ``index_add_`` atomics stray on
    pl_2e5's hub rows), and the residual rows at phase 2's limits to those
    of the kernel's own P_next; then its times beside phase 2's rows."""
    from repro_torch.core.fixed_point import Q1_25
    from repro_torch.kernels.fused_ppr import fused_ppr_iteration, fused_ppr_plain
    from repro_torch.ppr_serving.engine.fused import FusedRegisteredGraph

    rows = []
    for gname, g in graphs.items():
        frg = FusedRegisteredGraph(gname, g, packet=PACKET, v_tile=V_TILE, device=dev)
        topo, dang = frg.fused_topology(), frg.fused_dangling()
        st, v, n_dang = frg.fused_stream(), g.num_vertices, int(dang.shape[0])
        for k in DEEP_K:
            for fmt in (None, Q1_25):
                dom = "f32" if fmt is None else fmt.name
                what = f"fused {gname} {dom} K={k}"
                p_np, vm_np = _inputs(np, g, fmt, seed=k + (0 if fmt is None else 7), k=k)
                p, vm = (torch.as_tensor(a, device=dev) for a in (p_np, vm_np))
                val = frg.fused_values(fmt)
                fargs, fkw = (topo, val, dang, vm, p), dict(alpha=ALPHA, fmt=fmt)
                if fmt is None:
                    pn, res = fused_ppr_iteration(*fargs, **fkw)
                    pn64, _ = fused_ppr_plain(topo, val.double(), dang, vm.double(),
                                              p.double(), **fkw)
                    err = _check_float_p_next(torch, what, pn.double(), pn64)
                    d = (pn.double() - p.double()).abs()
                    own = torch.stack([d.sum(0), d.amax(0), (d * d).sum(0)])
                    for r in (0, 2):
                        if not torch.allclose(res[r].double(), own[r], rtol=1e-4, atol=0.0):
                            _fail(f"{what}: residual row {r} vs its own P_next's")
                    if float((res[1].double() - own[1]).abs().max()) > 1e-6:
                        _fail(f"{what}: inf residual vs its own P_next's")
                else:
                    err = _check_fused_iteration(torch, what, fargs, fmt)
                state = v * k * 4
                row = dict(kernel="fused_ppr_iteration", graph=gname, domain=dom, k=k,
                           max_abs_err=err, bound_ms=_bound_ms(
                               st.num_edges * 8 + (v + 1) * 4 + st.nz_rows.size * 4
                               + (st.num_slices + 1) * 4 + n_dang * 4 + 3 * state
                               + 3 * k * 4),
                           unpadded_bound_ms=_bound_ms(
                               g.num_edges * 8 + n_dang * 4 + 3 * state + 3 * k * 4))
                _timings(torch, row, lambda: fused_ppr_iteration(*fargs, **fkw),
                         lambda: fused_ppr_plain(*fargs, **fkw), plain_repeats=5)
                rows.append(row)
                print(f"[deep-k] {what}: kernel = plain (max abs err {err:.2e}); "
                      f"{row['ms']:.4f} ms a call, device {row['device_ms']:.4f} ms, "
                      f"bound {row['bound_ms']:.4f} ms "
                      f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of device), "
                      f"plain {row['plain_ms']:.4f} ms, {row['device_ops_per_call']} "
                      f"device ops a call")
        del frg
    return rows


def _phase3_traffic(np, g, n_fixed=64, n_float=32):
    rng = np.random.default_rng(2020)
    verts = rng.choice(g.num_vertices, n_fixed + n_float, replace=False)
    return [(int(v), 26) for v in verts[:n_fixed]] + [(int(v), None) for v in verts[n_fixed:]]


def _expected_sampled(rate, n):
    """The head-sampling draws of ``n`` submitted queries at ``rate``:
    the service's ``random.Random(0)``, one draw a query."""
    import random
    rng = random.Random(0)
    return sum(rng.random() < rate for _ in range(n))


def _wave_spans(traces, names=("plan", "iterate", "topk")):
    """Median ms of each named span over the wave traces in ``traces``."""
    waves = [tr for tr in traces if tr["kind"] == "wave"]
    return {name: statistics.median(
        [c["duration_s"] * 1e3 for tr in waves for c in tr["root"]["children"]
         if c["name"] == name]) for name in names} if waves else {}


def _traced_waves(torch, np, g, dev, card, passes=5):
    """(a) Phase 3's traffic through three fused services on gnp_2e5,
    untraced, ``tracing=True`` and ``tracing=0.1``, each without and then
    with ``early_exit=True``, the services in turns within each pass:
    equal answers and iteration counts, complete wave traces, the seeded
    sampled share, each service's wave p50 and span p50s, and the host ms
    of the untraced service's ``fused_ppr_iteration`` calls (the main
    thread's, beside (b)'s on the pump's worker)."""
    from repro_torch.autotune.convergence import ConvergencePolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ppr_serving import PPRQuery, PPRService

    queries = _phase3_traffic(np, g)
    services = {}
    for label, tracing in (("untraced", False), ("traced", True), ("sampled-0.1", 0.1)):
        svc = PPRService(kappa=K, iterations=10, alpha=ALPHA, cache_capacity=0,
                         tracing=tracing, device=dev)
        svc.register_graph("g", g, formats=[26], engine="fused")
        kinds = {"query": 0, "wave": 0}
        if svc.tracer is not None:
            inner = svc.tracer.sink

            def counted(tr, inner=inner, kinds=kinds):
                kinds[tr.kind] += 1
                inner(tr)
            svc.tracer.sink = counted
        services[label] = dict(svc=svc, kinds=kinds)
    out, launches, host_ms = {}, 0, []
    for exit_label, policy in (("no-exit", None), ("early-exit", ConvergencePolicy())):
        answers, n0 = {}, {}
        for label, s in services.items():
            svc = s["svc"]
            svc.convergence = policy            # what early_exit= sets
            _serve_batch(svc, PPRQuery, queries)        # warm-up pass
            torch.cuda.synchronize()
            svc.telemetry.reset()
            n0[label] = svc.recorder.traces_recorded
        reset_launch_counts()
        for _ in range(passes):
            for label, s in services.items():
                if label == "untraced" and policy is None:
                    answers[label], replayed, _ = _replay_host_ms(
                        lambda: _serve_batch(s["svc"], PPRQuery, queries))
                    host_ms += replayed
                else:
                    answers[label] = _serve_batch(s["svc"], PPRQuery, queries)
                torch.cuda.synchronize()
        launches += launch_counts()["fused_ppr_iteration"]
        for label, s in services.items():
            svc = s["svc"]
            t = svc.telemetry.summary()
            new = svc.recorder.traces_recorded - n0[label]
            traces = svc.recorder.traces()[-new:] if new else []
            waves = [tr for tr in traces if tr["kind"] == "wave"]
            for tr in waves:
                names = [c["name"] for c in tr["root"]["children"]]
                if names != ["plan", "warm_start", "iterate", "topk", "resolve"]:
                    _fail(f"traced {label} {exit_label}: wave spans {names}")
                it = tr["root"]["children"][2]["attrs"]
                want = {"iterations_run", "budget", "early_exit"} | (
                    {"residual"} if policy is not None else set())
                if set(it) != want or it["budget"] != 10:
                    _fail(f"traced {label} {exit_label}: iterate attrs {it}")
            out[f"{label} {exit_label}"] = dict(
                wave_p50_ms=t["wave_latency_p50_s"] * 1e3,
                wave_p95_ms=t["wave_latency_p95_s"] * 1e3, waves=int(t["waves"]),
                early_exit_waves=int(t["early_exit_waves"]),
                iterations_saved=int(t["iterations_saved"]),
                wave_traces=len(waves), span_p50_ms=_wave_spans(waves))
        base = answers["untraced"]
        for label in ("traced", "sampled-0.1"):
            _same_answers(np, f"tracing {label} {exit_label}", answers[label], base)
            for key in ("early_exit_waves", "iterations_saved", "waves"):
                a, b = out[f"{label} {exit_label}"][key], out[f"untraced {exit_label}"][key]
                if a != b:
                    _fail(f"tracing {label} {exit_label}: {key} {a} vs untraced {b}")
    submitted = 2 * (passes + 1) * len(queries)
    sampled = services["sampled-0.1"]["kinds"]["query"]
    want = _expected_sampled(0.1, submitted)
    if sampled != want or services["traced"]["kinds"]["query"] != submitted:
        _fail(f"tracing: {sampled} sampled query traces of {submitted} (seeded draw: "
              f"{want}); full tracing {services['traced']['kinds']['query']}")
    for label, s in services.items():
        tracer = s["svc"].tracer
        if tracer is not None and tracer.started != tracer.finished:
            _fail(f"tracing {label}: {tracer.started} traces started, "
                  f"{tracer.finished} finished")
    for key, r in out.items():
        print(f"[trace] {key}: wave p50 {r['wave_p50_ms']:.3f} ms (p95 "
              f"{r['wave_p95_ms']:.3f}), {r['waves']} waves, {r['early_exit_waves']} "
              f"exited early; {r['wave_traces']} wave traces; span p50 "
              f"{json.dumps({k: round(v, 4) for k, v in r['span_p50_ms'].items()})} ({card})")
    host_p50 = statistics.median(host_ms)
    print(f"[trace] answers with tracing = without (Q1.25 raw, f32 within 1e-6), "
          f"iteration counts equal; sampled {sampled}/{submitted} queries at 0.1 "
          f"(seeded draw {want}); the three services in turns each pass; host ms per "
          f"replayed wave on the main thread (untraced, no early exit) {host_p50:.4f}; "
          f"fused_ppr_iteration launches {launches}")
    return dict(runs=out, sampled=sampled, submitted=submitted, launches=launches,
                host_ms_per_replayed_wave_p50=host_p50,
                untraced=services["untraced"]["svc"])


async def _post_all(http, host, port, bodies, concurrency):
    """POST each body to /v1/ppr over ``concurrency`` keep-alive clients;
    returns [(status, headers, payload, seconds)] in body order."""
    import asyncio

    results = [None] * len(bodies)
    nxt = iter(range(len(bodies)))

    async def worker():
        client = http.AsyncHTTPClient(host, port)
        try:
            for i in nxt:
                t0 = time.perf_counter()
                status, headers, payload = await client.request("POST", "/v1/ppr", bodies[i])
                results[i] = (status, headers, payload, time.perf_counter() - t0)
        finally:
            await client.close()

    await asyncio.gather(*[worker() for _ in range(concurrency)])
    return results


async def _answers(what, requests, pump_task=None):
    """The result of the ``requests`` coroutine, or a failure when the
    pump task ends first (a wave raised: its clients would never be
    answered) or after ``HTTP_TIMEOUT_S``."""
    import asyncio

    task = asyncio.ensure_future(requests)
    waits = {task} if pump_task is None else {task, pump_task}
    done, _ = await asyncio.wait(waits, timeout=HTTP_TIMEOUT_S,
                                 return_when=asyncio.FIRST_COMPLETED)
    if task in done:
        return task.result()
    task.cancel()
    if pump_task is not None and pump_task in done:
        _fail(f"{what}: the pump ended with {pump_task.exception()!r}")
    _fail(f"{what}: no answer in {HTTP_TIMEOUT_S} s")


def _check_http_answers(np, what, results, bodies, mirror):
    """Every 200 answer equal to ``run_batch`` on ``mirror`` at the precision
    the response names: Q raw-equal scores (the dequantized raw values),
    float32 within 1e-6."""
    from repro_torch.ppr_serving import PPRQuery

    ok = [(b, r[2]) for b, r in zip(bodies, results) if r[0] == 200]
    recs = mirror.run_batch([PPRQuery("g", b["vertex"], k=b["k"],
                                      precision=None if p["precision"] == "f32"
                                      else p["precision"]) for b, p in ok])
    for (b, p), rec in zip(ok, recs):
        verts = [r["vertex"] for r in p["recommendations"]]
        scores = np.asarray([r["score"] for r in p["recommendations"]])
        if p["precision"] != rec.precision:
            _fail(f"{what}: vertex {b['vertex']} served at {p['precision']}, "
                  f"run_batch at {rec.precision}")
        if p["precision"] == "f32":
            err = float(np.abs(scores - rec.scores).max())
            if err > 1e-6:
                _fail(f"{what}: f32 answer for vertex {b['vertex']} off run_batch by {err}")
        elif verts != rec.vertices.tolist() or not np.array_equal(scores, rec.scores):
            _fail(f"{what}: {p['precision']} answer for vertex {b['vertex']} differs "
                  f"from run_batch")
    return len(ok)


def _http_tier(torch, np, g, dev, card, mirror):
    """(b) ``PPRHTTPServer`` over a fused, traced (0.1), SLO-monitored,
    OTLP-exporting service on gnp_2e5: the main load, then two bursts under
    a tight admission config with the pump held back (6 queries: κ → 32;
    then 160: κ → 64 and shedding)."""
    import asyncio

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import _build
    from repro_torch.obs import OTLPExporter
    from repro_torch.ppr_serving import PPRService, http

    col = _Collector()
    try:
        otlp = OTLPExporter(col.url)
        svc = PPRService(kappa=K, iterations=10, alpha=ALPHA, max_wait=0.005,
                         early_exit=True, tracing=0.1, slo=True, otlp=otlp, device=dev)
        svc.register_graph("g", g, formats=[26], engine="fused")
        mirror.convergence = svc.convergence
        rng = np.random.default_rng(17)
        precisions = (26, None, "auto")

        def bodies(n):
            return [{"graph": "g", "vertex": int(v), "k": 10,
                     "precision": precisions[i % 3]}
                    for i, v in enumerate(rng.integers(0, g.num_vertices, n))]

        main_bodies, burst_a, burst_b = bodies(HTTP_REQUESTS), bodies(6), bodies(160)

        async def serve_main():
            server = http.PPRHTTPServer(svc, host="127.0.0.1", port=0)
            await server.start()
            t0 = time.perf_counter()
            res = await _answers("http main", _post_all(
                http, server.host, server.port, main_bodies, HTTP_CONCURRENCY),
                server.pump._task)
            wall = time.perf_counter() - t0
            await server.stop()               # re-raises a pump that died
            return res, wall

        async def serve_bursts():
            # back to the base κ: a burning SLO holds the last server's κ
            # deepened past its drain, and a controller's base is the κ it
            # finds
            svc.set_kappa(K)
            server = http.PPRHTTPServer(svc, host="127.0.0.1", port=0,
                                        admission=http.AdmissionConfig(
                                            high_water=48, low_water=4, deepen_water=4,
                                            kappa_max=64, degrade_water=24,
                                            degrade_low_water=4))
            await server.transport.start()           # the pump held back
            host, port = server.host, server.port
            out = []
            for burst, admitted in ((burst_a, 6), (burst_b, 49)):
                # every arrival meets admission before a wave drains the queue:
                # the first ``admitted`` queue, the rest (depth > 48) are shed
                shed = server.admission.shed + len(burst) - admitted
                task = asyncio.ensure_future(_post_all(http, host, port, burst, len(burst)))
                # the burst's answers only once its pump starts: until then
                # the queued requests wait, as intended
                t_end = time.perf_counter() + HTTP_TIMEOUT_S
                while svc.queue_depth() < admitted or server.admission.shed < shed:
                    if time.perf_counter() > t_end:
                        _fail(f"burst: the queue reached {svc.queue_depth()} of {admitted}, "
                              f"{server.admission.shed} of {shed} shed")
                    await asyncio.sleep(0.002)
                server.pump.start()
                pump_task = server.pump._task
                out.append(await _answers("http burst", task, pump_task))
                await server.pump.stop()      # re-raises a pump that died
            endpoints = {}
            for path in ("/v1/healthz", "/v1/stats", "/v1/metrics", "/v1/slo",
                         "/v1/debug/traces?n=4"):
                status, _, payload = await http.http_request(host, port, "GET", path)
                endpoints[path] = (status, payload)
            await server.transport.stop()
            return out, endpoints

        with _KernelCalls(torch) as calls:
            reset_launch_counts()
            main, wall = asyncio.run(serve_main())
            summary = svc.telemetry_summary()             # the main load's
            main_traces = svc.recorder.traces()
            (res_a, res_b), endpoints = asyncio.run(serve_bursts())
            launches = launch_counts()["fused_ppr_iteration"]
        statuses = {}
        for r in main + res_a + res_b:
            statuses[r[0]] = statuses.get(r[0], 0) + 1
        if 500 in statuses or set(statuses) - {200, 429}:
            _fail(f"HTTP statuses {statuses}: only 200 and 429 (shed) are expected")
        if any(r[0] != 200 for r in main + res_a):
            _fail("the main load or the κ = 32 burst was shed")
        shed = [r for r in res_b if r[0] == 429]
        if len(shed) != 111 or any(r[2].get("code") != "shed"
                                   or float(r[1]["retry-after"]) <= 0 for r in shed):
            _fail(f"burst: {len(shed)} shed (want 111, each a 429 with Retry-After)")
        for path, (status, _) in endpoints.items():
            if status != 200:
                _fail(f"GET {path} answered {status}")
        checked = sum(_check_http_answers(np, what, res, b, mirror) for what, res, b in (
            ("http main", main, main_bodies), ("http κ=32 burst", res_a, burst_a),
            ("http κ=64 burst", res_b, burst_b)))
        kappas = [e["kappa"] for e in svc.recorder.events_of_kind("kappa")]
        by_k = calls.by_k()
        if not (32 in kappas and 64 in kappas and by_k.get(32) and by_k.get(64)):
            _fail(f"κ moves {kappas}, launches by K {by_k}: κ must reach 32 and 64 and "
                  f"waves launch at both")
        threads = {name for _, name, _, _ in calls.calls}
        streams = {s for _, _, s, _ in calls.calls}
        main_stream = torch.cuda.current_stream().cuda_stream
        tickets = [key for key in _build._tickets if key[0] == "fused_ppr"]
        if not all(t.startswith("ppr-wave") for t in threads) or streams != {main_stream}:
            _fail(f"served waves ran on threads {threads}, streams {streams} (the main "
                  f"thread's current stream: {main_stream})")
        s = otlp.stats()
        if (s["spans_exported"] != col.spans or s["spans_dropped"]
                or s["send_failures"] or not col.spans):
            _fail(f"OTLP: exporter {s}, collector received {col.spans} spans")
        lat = sorted(r[3] for r in main)
        host_ms = [ms for *_, ms in calls.calls]
        out = dict(
            requests=len(main), concurrency=HTTP_CONCURRENCY, wall_s=wall,
            requests_per_s=len(main) / wall,
            client_p50_ms=lat[len(lat) // 2] * 1e3,
            client_p99_ms=lat[int(0.99 * (len(lat) - 1))] * 1e3,
            waves=int(summary["waves"]), mean_occupancy=summary["mean_occupancy"],
            wave_latency_p50_ms=summary["wave_latency_p50_s"] * 1e3,
            statuses=statuses, shed=len(shed), kappa_moves=kappas, launches_by_k=by_k,
            launches=launches, checked_answers=checked, threads=sorted(threads),
            streams=sorted(streams), ticket_sets=[list(map(str, k)) for k in tickets],
            host_ms_per_iteration_p50=statistics.median(host_ms),
            otlp=s, collector_spans=col.spans, collector_metric_posts=col.metric_posts,
            slo_states={sp["name"]: sp["state"] for sp in endpoints["/v1/slo"][1]["specs"]},
            wave_span_p50_ms=_wave_spans(main_traces))
        print(f"[http] {len(main)} POSTs at concurrency {HTTP_CONCURRENCY}: "
              f"{out['requests_per_s']:.1f} requests/s, client p50/p99 "
              f"{out['client_p50_ms']:.2f}/{out['client_p99_ms']:.2f} ms, "
              f"{out['waves']} waves, mean occupancy "
              f"{out['mean_occupancy']:.3f}, wave p50 {out['wave_latency_p50_ms']:.3f} ms "
              f"(sampled wave traces' span p50 "
              f"{json.dumps({k: round(v, 3) for k, v in out['wave_span_p50_ms'].items()})}); "
              f"host ms per fused_ppr_iteration call on the worker {out['host_ms_per_iteration_p50']:.4f} "
              f"({card})")
        print(f"[http] bursts: κ moves {kappas}, fused_ppr_iteration launches by K "
              f"{by_k}; statuses {statuses}; {checked} answers = run_batch; waves on "
              f"threads {sorted(threads)}, stream {sorted(streams)} = the main thread's; "
              f"fused ticket sets {len(tickets)}; endpoints 200: "
              f"{', '.join(endpoints)}; SLO {out['slo_states']}")
        print(f"[http] OTLP: {s['spans_exported']} spans exported in "
              f"{s['span_batches_sent']} batches = {col.spans} received, "
              f"{s['metric_pushes']} metric pushes, {s['spans_dropped']} dropped, "
              f"{s['send_failures']} failed sends")
        return out
    finally:
        col.close()


def _driver_http(np, card, num_vertices):
    """(d) ``ppr_run --http 0 ... --trace --slo --otlp-endpoint`` as a
    subprocess (banner, 16 POSTs, GET /v1/slo, SIGINT: a clean exit and an
    ``otlp:`` line with 0 failed sends), and ``ppr_run --serve
    --dump-traces 3`` beside it (three span trees)."""
    import asyncio
    import os
    import queue
    import re
    import signal
    import threading

    from repro_torch.ppr_serving import http

    col = _Collector()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.launch.ppr_run", "--graph", "gnp_2e5",
            "--scale", "1.0", "--bits", "26", "--kappa", str(K)]
    t0 = time.perf_counter()
    serve = subprocess.Popen(base + ["--http", "0", "--trace", "--slo",
                                     "--otlp-endpoint", col.url],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT))
    dump = subprocess.Popen(base + ["--serve", "--requests", "64", "--dump-traces", "3"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=str(ROOT))
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in serve.stdout] + [lines.put("")],
                         daemon=True).start()
        banner = []
        while not banner or "GET  /v1/debug/traces" not in banner[-1]:
            try:
                line = lines.get(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            except queue.Empty:
                _fail("ppr_run --http printed no banner in 300 s")
            if not line:
                _fail(f"ppr_run --http exited early: {serve.stderr.read()[-2000:]}")
            banner.append(line.rstrip("\n"))
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", "\n".join(banner)).group(1))
        rng = np.random.default_rng(5)
        bodies = [{"graph": "gnp_2e5", "vertex": int(v), "k": 10,
                   "precision": (26, None, "auto")[i % 3]}
                  for i, v in enumerate(rng.integers(0, num_vertices, 16))]

        async def traffic():
            res = await _answers("ppr_run --http", _post_all(
                http, "127.0.0.1", port, bodies, 4))
            slo = await http.http_request("127.0.0.1", port, "GET", "/v1/slo")
            return res, slo

        res, slo = asyncio.run(traffic())
        serve.send_signal(signal.SIGINT)
        serve.wait(timeout=120)
        rest = []
        while True:
            line = lines.get(timeout=30)
            if not line:
                break
            rest.append(line.rstrip("\n"))
        err = serve.stderr.read()
        out_d, err_d = dump.communicate(timeout=300)
    finally:
        for proc in (serve, dump):
            if proc.poll() is None:
                proc.kill()
            with proc:                    # closes the pipes, reaps the process
                pass
        col.close()
    wall = time.perf_counter() - t0
    if serve.returncode != 0:
        _fail(f"ppr_run --http exited {serve.returncode}: {err[-2000:]}")
    if [r[0] for r in res] != [200] * 16 or slo[0] != 200:
        _fail(f"ppr_run --http: statuses {[r[0] for r in res]}, /v1/slo {slo[0]}")
    otlp_line = [ln for ln in rest if ln.startswith("otlp:")]
    if len(otlp_line) != 1 or not otlp_line[0].endswith(" 0 failed sends") \
            or int(otlp_line[0].split()[1]) != col.spans:
        _fail(f"ppr_run --http: otlp line {otlp_line}, collector {col.spans} spans")
    if dump.returncode != 0:
        _fail(f"ppr_run --serve --dump-traces 3 exited {dump.returncode}: {err_d[-2000:]}")
    trees = [ln for ln in out_d.splitlines() if ln.startswith("  trace ")]
    if len(trees) != 3:
        _fail(f"ppr_run --dump-traces 3 printed {len(trees)} span trees")
    lat = sorted(r[3] for r in res)
    print(f"[driver-http] ppr_run --http: banner read, 16 POSTs 200 (client p50 "
          f"{lat[len(lat) // 2] * 1e3:.2f} ms), /v1/slo 200, SIGINT: exit 0, "
          f"'{otlp_line[0]}' = {col.spans} spans received; ppr_run --serve "
          f"--dump-traces 3: exit 0, 3 span trees; both in {wall:.1f} s ({card})")
    return dict(wall_s=wall, otlp_line=otlp_line[0], collector_spans=col.spans,
                client_p50_ms=lat[len(lat) // 2] * 1e3, dump_trees=trees)


def observability_phase(torch, np, graphs, dev, card):
    """Phase 9: (a) tracing on the fused wave, (b) the HTTP tier, (c) the
    kernel at K = 32 and 64, (d) the driver's HTTP and trace modes.
    ``launches`` counts fused_ppr_iteration over (a)'s and (b)'s served
    waves; (c)'s comparisons are not counted."""
    t0 = time.perf_counter()
    deep = _deep_kernel_rows(torch, np, graphs, dev)
    t1 = time.perf_counter()
    traced = _traced_waves(torch, np, graphs["gnp_2e5"], dev, card)
    t2 = time.perf_counter()
    tier = _http_tier(torch, np, graphs["gnp_2e5"], dev, card, traced.pop("untraced"))
    t3 = time.perf_counter()
    driver = _driver_http(np, card, graphs["gnp_2e5"].num_vertices)
    launches = traced["launches"] + tier["launches"]
    print(f"[obs] phase 9 took {time.perf_counter() - t0:.1f} s ((c) {t1 - t0:.1f}, "
          f"(a) {t2 - t1:.1f}, (b) {t3 - t2:.1f}, (d) {time.perf_counter() - t3:.1f}); "
          f"fused_ppr_iteration launches {launches}")
    return dict(deep_rows=deep, tracing=traced, http=tier, driver=driver,
                launches=launches, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 10: mesh-sharded serving
# ---------------------------------------------------------------------------
SHARD_COUNTS = (3, 4, 8)        # 3: a short last shard
MESH_SHARDS = 4
MESH_PASSES = 5


def _shard_bound_ms(np, st, k):
    """The bytes one shard's call must move over HBM's rate: its stream
    (col and val, 4 + 4 B an edge, row_ptr, nz_rows and the slice schedule),
    each P row it reads once (its distinct src) and its output rows once."""
    srcs = int(np.unique(st.col).size)
    return _bound_ms(st.num_edges * 8 + (st.num_rows + 1) * 4 + st.nz_rows.size * 4
                     + (st.num_slices + 1) * 4 + srcs * k * 4 + st.num_rows * k * 4)


def _check_shard_out(torch, what, out, topo, val, p, fmt) -> float:
    """A shard's kernel output against its plain version: raw bits equal, or
    float32 within rtol 1e-5 + atol 1e-9 and 1e-6 of the plain version run
    in float64.  Returns the max abs error."""
    from repro_torch.kernels.coo_spmv import coo_spmv_plain

    if fmt is not None:
        if not torch.equal(out, coo_spmv_plain(topo, val, p, frac_bits=fmt.frac_bits)):
            _fail(f"{what}: raw bits differ from the plain version")
        return 0.0
    want = coo_spmv_plain(topo, val.double(), p.double())
    err = float((out.double() - want).abs().max()) if out.numel() else 0.0
    if not torch.allclose(out.double(), want, rtol=1e-5, atol=1e-9) or err > 1e-6:
        _fail(f"{what}: max abs err {err} from the plain version in float64")
    return err


def _shard_kernels(torch, np, graphs, dev, card):
    """(a) ``coo_spmv_kernel`` over every shard stream of gnp_2e5 and pl_2e5
    at S ∈ SHARD_COUNTS, K = 16, f32 and Q1.25: each shard against its plain
    version, the gathered rows against the whole graph's plain SpMV, each
    shard's device ms beside its byte bound; one synthetic shard with rows
    and no edge over memory left full of ones; the largest shard at S = 4
    timed in full for the kernels line."""
    from repro_torch.core.fixed_point import Q1_25
    from repro_torch.core.spmv import (partition_edges_by_dst, sharded_vertex_layout,
                                       spmv_fixed, spmv_float)
    from repro_torch.kernels.coo_spmv import coo_spmv_kernel, coo_spmv_plain
    from repro_torch.kernels.dst_stream import build_dst_stream

    shards, rows = [], []
    for gname, g in graphs.items():
        v = g.num_vertices
        x, y = torch.as_tensor(g.x, device=dev), torch.as_tensor(g.y, device=dev)
        p_np, _ = _inputs(np, g, None, seed=100 + len(gname))
        p32 = torch.as_tensor(p_np, device=dev)
        p_of = {None: p32, Q1_25: Q1_25.from_float(p32)}
        whole = {None: spmv_float(x, y, torch.as_tensor(g.val, device=dev).double(),
                                  p32.double(), v),
                 Q1_25: spmv_fixed(x, y, torch.as_tensor(g.quantized_val(Q1_25).view(np.int32),
                                                         device=dev), p_of[Q1_25], v, Q1_25)}
        for s in SHARD_COUNTS:
            v_local, _ = sharded_vertex_layout(v, s)
            hx, hy, hv = (a.reshape(s, -1) for a in partition_edges_by_dst(g.x, g.y, g.val, v, s))
            streams = [build_dst_stream((hx[i], hy[i], hv[i], v_local)) for i in range(s)]
            for fmt in (None, Q1_25):
                dom = "f32" if fmt is None else fmt.name
                p, fb = p_of[fmt], None if fmt is None else fmt.frac_bits
                parts = []
                for i, st in enumerate(streams):
                    topo, val = st.topology(dev), st.values(dev, fmt)
                    call = (lambda topo=topo, val=val:
                            coo_spmv_kernel(topo, val, p, frac_bits=fb))
                    out = call()
                    what = f"coo_spmv {gname} shard {i}/{s} {dom}"
                    err = _check_shard_out(torch, what, out, topo, val, p, fmt)
                    parts.append(out)
                    entry = dict(graph=gname, shards=s, shard=i, domain=dom,
                                 edges=st.num_edges, rows=st.num_rows,
                                 slice_edges=st.slice_edges, ctas=st.num_ctas,
                                 max_abs_err=err, bound_ms=_shard_bound_ms(np, st, K),
                                 device_ms=_time_ms(torch, call, hide_host=True))
                    shards.append(entry)
                    if s == MESH_SHARDS and st.num_edges == max(t.num_edges for t in streams):
                        row = dict(kernel="coo_spmv", graph=gname, domain=dom,
                                   shard=f"{i} of {s}", max_abs_err=err,
                                   bound_ms=entry["bound_ms"],
                                   unpadded_bound_ms=entry["bound_ms"])
                        _timings(torch, row, call,
                                 lambda topo=topo, val=val: coo_spmv_plain(
                                     topo, val, p, frac_bits=fb))
                        if fmt is None:     # one torch.sparse.mm on a CSR copy of the shard
                            X = torch.sparse_csr_tensor(
                                topo.row_ptr.long(), topo.col.long(), val, (v_local, v))
                            _library_timings(torch, row, lambda X=X: torch.sparse.mm(X, p))
                            lib_err = float((torch.sparse.mm(X, p) - out).abs().max())
                            if lib_err > 1e-6:
                                _fail(f"{what} vs torch.sparse.mm: {lib_err}")
                        rows.append(row)
                got = torch.cat(parts)[:v]
                if fmt is None:
                    err = float((got.double() - whole[None]).abs().max())
                    if not torch.allclose(got.double(), whole[None], rtol=1e-5, atol=1e-9):
                        _fail(f"coo_spmv {gname} S={s} f32: gathered rows {err} from the "
                              f"whole graph's plain SpMV in float64")
                elif not torch.equal(got, whole[Q1_25]):
                    _fail(f"coo_spmv {gname} S={s} {dom}: gathered rows differ from the "
                          f"whole graph's plain SpMV")
            sh = [e for e in shards if e["graph"] == gname and e["shards"] == s]
            print(f"[shards] {gname} S={s}: edges per shard "
                  f"{[e['edges'] for e in sh if e['domain'] == 'f32']}; device ms "
                  f"f32 {[round(e['device_ms'], 4) for e in sh if e['domain'] == 'f32']}, "
                  f"Q1.25 {[round(e['device_ms'], 4) for e in sh if e['domain'] != 'f32']}; "
                  f"bound ms {[round(e['bound_ms'], 4) for e in sh if e['domain'] == 'f32']}; "
                  f"each shard = its plain version, the gathered rows = the whole "
                  f"graph's ({card})")
    # a shard with 50,000 rows and no edge, over memory left full of ones
    st = build_dst_stream((np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.float32), 50_000))
    for fmt in (None, Q1_25):
        p = torch.ones((16, K), device=dev,
                       dtype=torch.float32 if fmt is None else torch.int32)
        junk = torch.full((50_000 * K,), -1, dtype=torch.int32, device=dev)
        del junk
        topo, val = st.topology(dev), st.values(dev, fmt)
        out = coo_spmv_kernel(topo, val, p, frac_bits=None if fmt is None else fmt.frac_bits)
        torch.cuda.synchronize()
        if out.shape != (50_000, K) or out.any():
            _fail(f"coo_spmv on a zero-edge shard ({fmt}): not all rows zero")
    print(f"[shards] a zero-edge shard of 50,000 rows (1 slice, 1 CTA): every row 0, "
          f"f32 and Q1.25")
    return shards, rows


def _in_turns(torch, runs, passes):
    """Each run of ``runs`` once to warm up, then ``passes`` passes in turns
    (the order flipped every pass); seconds a pass, by name."""
    for run in runs.values():
        run()
    secs = {name: [] for name in runs}
    names = list(runs)
    for i in range(passes):
        for name in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            runs[name]()
            secs[name].append(time.perf_counter() - t0)
    return secs


def _host_split(torch, run):
    """Host ms of one served pass of a sharded service, split: the per-shard
    ``coo_spmv_kernel`` calls, the gather (``core.spmv._gather_shards``),
    the dangling mass and the combine (``core.ppr``'s own), each without a
    synchronize; and the pass's calls of each."""
    import repro_torch.core.ppr as core_ppr
    import repro_torch.core.spmv as core_spmv
    import repro_torch.kernels.coo_spmv as kmod

    hooks = {"shard_calls": (kmod, "coo_spmv_kernel"),
             "gather": (core_spmv, "_gather_shards"),
             "dangling": (core_ppr, "_fixed_dangling_mass"),
             "combine_fixed": (core_ppr, "_fixed_combine"),
             "combine_float": (core_ppr, "_float_combine")}
    spent = {k: [0.0, 0] for k in hooks}
    inner = {k: getattr(mod, attr) for k, (mod, attr) in hooks.items()}

    def clocked(key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = inner[key](*a, **kw)
            spent[key][0] += (time.perf_counter() - t0) * 1e3
            spent[key][1] += 1
            return out
        call.launches = 0      # the kernel wrapper counts on the name it is bound to
        return call

    for key, (mod, attr) in hooks.items():
        setattr(mod, attr, clocked(key))
    try:
        t0 = time.perf_counter()
        run()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for key, (mod, attr) in hooks.items():
            setattr(mod, attr, inner[key])
    return dict(pass_ms=total, **{k: dict(ms=v[0], calls=v[1]) for k, v in spent.items()})


def _sharded_service(torch, np, graphs, dev, card):
    """(b) phase 3's traffic through a 4-shard meshed service, a fused and a
    single one on gnp_2e5 and pl_2e5: answers held to each other and to the
    scipy oracle's top-10 as phase 3 holds the fused family's, telemetry
    under the mesh's key, the passes of the meshed and the fused service
    timed in turns, and the host time of a meshed pass split.  The coo_spmv
    launches counted are those of the meshed services' served passes."""
    from repro_torch.graphs import ppr_reference
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import PPRQuery, PPRService

    mesh = make_mesh((MESH_SHARDS,), ("shard",), device=dev)
    one = len(set(mesh.axis_devices("shard"))) == 1
    print(f"[mesh] {MESH_SHARDS}-shard mesh on {mesh.placement}"
          f"{': every shard on one device, so no copy crosses cards' if one else ''} ({card})")
    out, launches = {}, 0
    for gname, g in graphs.items():
        rng = np.random.default_rng(2020)
        verts = rng.choice(g.num_vertices, 96, replace=False)
        queries = [(int(v), 26) for v in verts[:64]] + [(int(v), None) for v in verts[64:]]
        svcs, runs = {}, {}
        for name, kw in (("sharded", dict(mesh=mesh)), ("fused", dict(engine="fused")),
                         ("single", dict(engine="single"))):
            svc = PPRService(kappa=K, iterations=10, cache_capacity=0, device=dev)
            svc.register_graph("g", g, formats=[26], **kw)
            svcs[name] = svc
            runs[name] = (lambda svc=svc: (_serve_batch(svc, PPRQuery, queries),
                                          torch.cuda.synchronize())[0])
        reset_launch_counts()
        answers = {"sharded": runs["sharded"]()}
        counts = launch_counts()
        if counts["coo_spmv"] == 0 or counts["fused_ppr_iteration"]:
            _fail(f"the meshed service on {gname} launched {counts}: coo_spmv must run "
                  f"and fused_ppr_iteration must not")
        launches += counts["coo_spmv"]
        answers["fused"], answers["single"] = runs["fused"](), runs["single"]()
        agree = _same_answers(np, f"{gname} sharded vs fused", answers["sharded"],
                              answers["fused"])
        _same_answers(np, f"{gname} sharded vs single", [
            a for a in answers["sharded"] if a.precision != "f32"],
            [a for a in answers["single"] if a.precision != "f32"])
        pers = np.asarray([v for v, _ in queries[:4]] + [v for v, _ in queries[-4:]])
        ref = ppr_reference(g, pers, alpha=ALPHA, iterations=100)
        overlaps = {}
        for name in ("sharded", "fused"):
            recs = answers[name]
            ov = []
            for j, v in enumerate(pers):
                col = ref[:, j].copy()
                col[v] = -np.inf
                top = set(np.argsort(-col, kind="stable")[:10].tolist())
                rec = recs[j] if j < 4 else recs[len(recs) - 8 + j]
                ov.append(len(top & set(rec.vertices.tolist())))
            overlaps[name] = ov
        if overlaps["sharded"] != overlaps["fused"]:
            _fail(f"{gname}: oracle top-10 overlaps {overlaps}")
        for name in ("sharded", "fused"):
            svcs[name].telemetry.reset()
        secs = _in_turns(torch, {k: runs[k] for k in ("sharded", "fused")}, MESH_PASSES)
        summ = {k: svcs[k].telemetry_summary() for k in ("sharded", "fused")}
        key = f"waves_mesh:shardx{MESH_SHARDS}"
        if summ["sharded"].get(key) != summ["sharded"]["waves"] or not summ["sharded"]["waves"]:
            _fail(f"{gname}: telemetry {key} = {summ['sharded'].get(key)}, waves "
                  f"{summ['sharded']['waves']}")
        split = _host_split(torch, runs["sharded"])
        busy = _busy_profile(torch, runs["sharded"])
        if not busy["device_events"]:
            _fail("torch.profiler saw no device event in the meshed passes")
        waves = summ["sharded"]["waves"] / (MESH_PASSES + 1)
        r = dict(waves_per_pass=waves, float_lists_equal=agree, oracle_overlaps=overlaps,
                 host_split=split, profile=busy, launches=counts["coo_spmv"])
        for name in ("sharded", "fused"):
            r[name] = dict(wave_p50_ms=summ[name]["wave_latency_p50_s"] * 1e3,
                           wave_p95_ms=summ[name]["wave_latency_p95_s"] * 1e3,
                           queries_per_s=96 * MESH_PASSES / sum(secs[name]),
                           pass_s=secs[name])
        out[gname] = r
        per_wave = {k: round(v["ms"] / waves, 4) for k, v in split.items() if k != "pass_ms"}
        print(f"[sharded] {gname}: 96 queries (64 Q1.25 + 32 f32) on the mesh = fused "
              f"(Q1.25 raw bits, f32 within 1e-6, float lists equal {agree}/32) = single "
              f"(Q1.25); oracle top-10 overlaps {overlaps['sharded']}; {key} "
              f"{summ['sharded'][key]}; coo_spmv launches {counts['coo_spmv']} a pass "
              f"({counts['coo_spmv'] / waves:g} a wave)")
        print(f"[sharded] {gname} over {MESH_PASSES} passes in turns: wave p50/p95 sharded "
              f"{r['sharded']['wave_p50_ms']:.3f}/{r['sharded']['wave_p95_ms']:.3f} ms, "
              f"fused {r['fused']['wave_p50_ms']:.3f}/{r['fused']['wave_p95_ms']:.3f} ms; "
              f"queries/s sharded {r['sharded']['queries_per_s']:.1f}, fused "
              f"{r['fused']['queries_per_s']:.1f}; host ms a wave, sharded pass "
              f"{split['pass_ms'] / waves:.3f}: {json.dumps(per_wave)} ({card})")
        print(f"[sharded] {gname} profile over {busy['passes']} meshed passes: device busy "
              f"{100 * busy['device_busy_share']:.1f}% of {busy['window_ms']:.2f} ms; by "
              f"name {json.dumps({k: round(v, 3) for k, v in busy['device_ms_by_name'].items()})}")
    return out, launches


def _sharded_early_exit(torch, np, g, dev, card, budget=120, bits=20):
    """(c) pl_2e5, Q1.19, early exit, budget 120: the sharded and the fused
    plan stop after the same iterations with the same states."""
    from repro_torch.autotune import ConvergencePolicy
    from repro_torch.core.fixed_point import format_for_bits
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import ShardedRegisteredGraph, get_engine
    from repro_torch.ppr_serving.engine.fused import FusedRegisteredGraph

    fmt = format_for_bits(bits)
    pers = torch.as_tensor(np.random.default_rng(7).choice(g.num_vertices, K, replace=False),
                           device=dev)
    mesh = make_mesh((MESH_SHARDS,), ("shard",), device=dev)
    res = {}
    for key, rg in (("sharded_fixed", ShardedRegisteredGraph("g", g, mesh, device=dev)),
                    ("fused_fixed", FusedRegisteredGraph("g", g, v_tile=V_TILE, device=dev))):
        plan = get_engine(key).plan(rg, fmt, alpha=ALPHA, iterations=budget,
                                    convergence=ConvergencePolicy())
        Vmat = plan.initial(pers)
        res[key] = plan.iterate(lambda P_: plan.step(Vmat, P_), Vmat)
    (p_s, it_s), (p_f, it_f) = res["sharded_fixed"], res["fused_fixed"]
    if it_s != it_f or not torch.equal(p_s, p_f):
        _fail(f"early exit: sharded {it_s} iterations, fused {it_f}; states equal "
              f"{torch.equal(p_s, p_f)}")
    print(f"[sharded] early exit pl_2e5 {fmt.name} budget {budget}: sharded and fused both "
          f"stop after {it_f} iterations with identical states")
    return dict(budget=budget, iterations_run=it_f)


def _sharded_deltas(torch, np, g, dev, card):
    """(d) one random_delta(1024, 512) and one growth of 256 vertices on the
    meshed gnp_2e5: host buckets and streams equal a fresh registration's,
    answers equal a fresh registration's; ``apply_delta`` ms and its stages."""
    from repro_torch.core.fixed_point import Q1_25
    from repro_torch.graph_updates import random_delta
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import PPRQuery, PPRService

    mesh = make_mesh((MESH_SHARDS,), ("shard",), device=dev)
    svc = PPRService(kappa=K, iterations=10, cache_capacity=0, device=dev)
    rg = svc.register_graph("g", g, formats=[26], mesh=mesh)
    rng = np.random.default_rng(2022)
    queries = [(int(v), prec) for v in rng.choice(g.num_vertices, 16, replace=False)
               for prec in (26, None)]
    _serve_batch(svc, PPRQuery, queries)
    out = []
    for kind, seed in (("random_delta(1024, 512)", 0), ("growth of 256", 11)):
        rng = np.random.default_rng(seed)
        delta = (random_delta(rg.source, rng, n_add=1024, n_remove=512) if seed == 0
                 else random_delta(rg.source, rng, n_add=0, n_remove=0, grow=256))
        t0 = time.perf_counter()
        rep = svc.apply_delta("g", delta)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fresh = PPRService(kappa=K, iterations=10, cache_capacity=0, device=dev)
        frg = fresh.register_graph("g", rg.source, formats=[26], mesh=mesh)
        for name in ("_host_x", "_host_y", "_host_val"):
            if not np.array_equal(getattr(rg, name), getattr(frg, name)):
                _fail(f"delta {kind}: {name} differs from a fresh registration's")
        if not np.array_equal(rg._sharded_quant_host[Q1_25], frg._sharded_quant_host[Q1_25]):
            _fail(f"delta {kind}: the Q1.25 buckets differ from a fresh registration's")
        for i, (a, b) in enumerate(zip(rg.shard_streams, frg.shard_streams)):
            for f in DELTA_FIELDS + ("val",):
                if not np.array_equal(getattr(a, f), getattr(b, f)):
                    _fail(f"delta {kind}: shard {i}'s stream {f} differs from a fresh build")
            for key in b._device:
                if key not in a._device:
                    _fail(f"delta {kind}: shard {i}'s refreshed stream lacks upload {key}")
        probe = queries + [(g.num_vertices + 3, 26)] if seed else queries
        _same_answers(np, f"delta {kind}", _serve_batch(svc, PPRQuery, probe),
                      _serve_batch(fresh, PPRQuery, probe), float_tol=0.0)
        stages = {k: round(v * 1e3, 3) for k, v in rg.delta_timings.items()}
        out.append(dict(kind=kind, apply_ms=ms, report_apply_s=rep["apply_s"],
                        stages_ms=stages, rebuilt_shards=rg.last_refresh_shards))
        print(f"[sharded] delta {kind}: apply_delta {ms:.1f} ms ({stages}), shards "
              f"rebuilt {rg.last_refresh_shards if rg.last_refresh_shards is not None else 'all (re-partition)'}; "
              f"buckets, streams and answers = a fresh registration's ({card})")
        del fresh, frg
    return out


def _sharded_auto(torch, np, g, dev, card):
    """(e) precision="auto" on the mesh: 8 waves of 16 (``AutotuneConfig()``)
    through a meshed and a fused service: the same resolved precisions,
    controller states and answers, shadow scores within 1e-4; every shadow
    reference of the meshed service through the sharded float engine."""
    from repro_torch.autotune import AutotuneConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import PPRQuery, PPRService

    traffic = _auto_traffic(np, g, seed=0)[:8]
    mesh = make_mesh((MESH_SHARDS,), ("shard",), device=dev)
    runs = {}
    for name, kw in (("sharded", dict(mesh=mesh)), ("fused", dict(engine="fused"))):
        svc = PPRService(kappa=K, iterations=10, alpha=ALPHA, autotune=AutotuneConfig(),
                         cache_capacity=0, device=dev)
        svc.register_graph("g", g, **kw)
        engines = []
        inner = svc._float_reference
        svc._float_reference = (lambda rg, eng, pers, inner=inner, engines=engines:
                                engines.append(eng.key) or inner(rg, eng, pers))
        recs, secs = _timed_waves(torch, svc, PPRQuery, traffic, "auto")
        runs[name] = dict(svc=svc, recs=recs, secs=secs, engines=engines)
    s, f = runs["sharded"], runs["fused"]
    for ws, wf in zip(s["recs"], f["recs"]):
        if [r.precision for r in ws] != [r.precision for r in wf]:
            _fail("auto on the mesh: resolved precisions differ from the fused family's")
        _same_answers(np, "auto sharded vs fused", ws, wf)
    if s["svc"].controller.summary() != f["svc"].controller.summary():
        _fail(f"auto on the mesh: controllers differ: {s['svc'].controller.summary()} vs "
              f"{f['svc'].controller.summary()}")
    a, b = s["svc"].telemetry.shadow_scores, f["svc"].telemetry.shadow_scores
    if len(a) != len(b) or not a or np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-4:
        _fail(f"auto on the mesh: shadow scores {a} vs {b}")
    if set(s["engines"]) != {"sharded_float"}:
        _fail(f"auto on the mesh: shadow references ran through {set(s['engines'])}")
    rung = s["svc"].controller.summary()
    p50 = {k: statistics.median(r["secs"]) * 1e3 for k, r in runs.items()}
    print(f"[sharded] auto on the mesh, gnp_2e5, 8 waves of 16: precisions, controller "
          f"({rung}) and answers = fused; {len(a)} shadow samples within 1e-4, each "
          f"reference through sharded_float; wave p50 sharded {p50['sharded']:.3f} ms, "
          f"fused {p50['fused']:.3f} ms ({card})")
    return dict(shadow_samples=len(a), controller=rung, wave_p50_ms=p50)


def _paper_envelope(torch, np, dev, card, waves=5):
    """(f) ``PPR_PAPER_1M``: 2^20 vertices, 2^24 edges (``erdos_renyi`` from a
    seed), κ = 16, Q1.25, on a 4-shard mesh against the fused family at its
    serving default on the same graph.  Both families' plans drive the same
    waves (initial, iterate, top-K, to a synchronize): states raw-equal,
    top-K equal, wave p50 each; then one served batch on the mesh equals the
    fused plan's top-K; the device bytes of the shard streams against the
    fused stream."""
    from repro_torch.configs.ppr_paper import PPR_PAPER_1M as W
    from repro_torch.core.fixed_point import format_for_bits
    from repro_torch.graphs import erdos_renyi
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.ppr_serving import (PPRQuery, PPRService, ShardedRegisteredGraph,
                                         get_engine)
    from repro_torch.ppr_serving.engine.fused import FusedRegisteredGraph

    t0 = time.perf_counter()
    g = erdos_renyi(W.num_vertices, W.num_edges, seed=1)
    t_gen = time.perf_counter() - t0
    fmt = format_for_bits(W.bits)
    mesh = make_mesh((MESH_SHARDS,), ("shard",), device=dev)
    t0 = time.perf_counter()
    srg = ShardedRegisteredGraph("g", g, mesh, device=dev)
    get_engine("sharded_fixed").prepare(srg, fmt)
    t_shard = time.perf_counter() - t0
    t0 = time.perf_counter()
    frg = FusedRegisteredGraph("g", g, device=dev)
    get_engine("fused_fixed").prepare(frg, fmt)
    t_fused = time.perf_counter() - t0

    def stream_bytes(st):
        return sum(a.nbytes for a in (st.row_ptr, st.col, st.nz_rows, st.slice_row)) \
            + 4 * st.num_edges
    bytes_sharded = sum(stream_bytes(st) for st in srg.shard_streams)
    bytes_fused = stream_bytes(frg.fused_stream())
    rng = np.random.default_rng(3)
    pers_all = [torch.as_tensor(rng.choice(g.num_vertices, W.kappa, replace=False),
                                device=dev) for _ in range(waves + 1)]
    plans = {key: get_engine(key).plan(rg, fmt, alpha=W.alpha, iterations=W.iterations)
             for key, rg in (("sharded_fixed", srg), ("fused_fixed", frg))}
    secs = {key: [] for key in plans}
    last = {}
    for i, pers in enumerate(pers_all):
        for key in (list(plans) if i % 2 == 0 else list(plans)[::-1]):
            plan = plans[key]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Vmat = plan.initial(pers)
            P, _ = plan.iterate(lambda P_: plan.step(Vmat, P_), Vmat)
            idx, vals = plan.topk(P, 10, pers)
            idx, vals = idx.cpu(), vals.cpu()
            if i:
                secs[key].append(time.perf_counter() - t0)
            last[key] = (P, idx, vals)
        (ps, is_, vs), (pf, if_, vf) = last["sharded_fixed"], last["fused_fixed"]
        if not (torch.equal(ps, pf) and torch.equal(is_, if_) and torch.equal(vs, vf)):
            _fail(f"PPR_PAPER_1M wave {i}: sharded and fused states or top-K differ")
    del last, ps, pf
    svc = PPRService(kappa=W.kappa, iterations=W.iterations, cache_capacity=0, device=dev)
    svc.register_graph("g", g, formats=[W.bits], mesh=mesh)
    pers = pers_all[-1]
    recs = svc.run_batch([PPRQuery("g", int(v), k=10, precision=W.bits) for v in pers.tolist()])
    for j, rec in enumerate(recs):
        if not np.array_equal(rec.vertices, if_[j].numpy()) or not np.array_equal(
                rec.scores, vf[j].numpy().view(np.uint32).astype(np.float64) / fmt.scale):
            _fail(f"PPR_PAPER_1M: the served answer for vertex {rec.query.vertex} differs "
                  f"from the fused plan's top-K")
    p50 = {k: statistics.median(v) * 1e3 for k, v in secs.items()}
    print(f"[envelope] PPR_PAPER_1M: |V|={g.num_vertices:,} |E|={g.num_edges:,} made in "
          f"{t_gen:.1f} s; registered: 4 shards {t_shard:.1f} s, fused "
          f"{t_fused:.1f} s; {waves} Q1.25 waves of {W.kappa} in turns: states and top-K "
          f"raw-equal, wave p50 sharded {p50['sharded_fixed']:.3f} ms, fused "
          f"{p50['fused_fixed']:.3f} ms; a served batch on the mesh = the fused top-K; "
          f"device bytes of the streams (topology + Q1.25 values): shards "
          f"{bytes_sharded:,}, fused {bytes_fused:,} ({card})")
    return dict(num_vertices=g.num_vertices, num_edges=g.num_edges, generate_s=t_gen,
                register_sharded_s=t_shard, register_fused_s=t_fused,
                wave_p50_ms=p50, wave_s=secs, stream_bytes_sharded=bytes_sharded,
                stream_bytes_fused=bytes_fused)


def _sharded_driver(np, dev, card, serve_stdout, timeout=600):
    """(g) ``ppr_run --serve --shards 4`` on gnp_2e5 at full size as a
    subprocess: exit 0, its placement line, and its count lines equal to
    phase 8's ``--serve`` run's with the layout words mapped (``--serve``
    prints no accuracy block: it returns top-K, not dense scores)."""
    import os
    import re

    from repro_torch.launch.mesh import make_mesh

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.ppr_run", "--graph", "gnp_2e5",
           "--scale", "1.0", "--bits", "26", "--kappa", str(K), "--requests", "64",
           "--serve", "--shards", str(MESH_SHARDS)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                         cwd=str(ROOT))
    wall = time.perf_counter() - t0
    if run.returncode:
        _fail(f"ppr_run --serve --shards {MESH_SHARDS} exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
    subs = [(re.compile(r"in [\d.]+s \([\d.]+ req/s"), "in <s>"),
            (re.compile(r"\d+-shard mesh"), "single-device"),
            (re.compile(r"mesh:shardx\d+"), "single"),
            (re.compile(r"engine_sharded_"), "engine_")]

    def counts(stdout):
        lines = []
        for ln in stdout.splitlines():
            if ln.startswith("mesh: ") or re.match(r"\s+\S*(latency|_per_s)\S*\s", ln):
                continue
            for pat, sub in subs:
                ln = pat.sub(sub, ln)
            lines.append(tuple(ln.split()))
        return sorted(lines)

    placement = [ln for ln in run.stdout.splitlines() if ln.startswith("mesh: ")]
    where = make_mesh((MESH_SHARDS,), ("shard",), device=dev).placement
    if placement != [f"mesh: {MESH_SHARDS} shards on {where}"]:
        _fail(f"ppr_run --shards: placement lines {placement}")
    if counts(run.stdout) != counts(serve_stdout):
        _fail(f"ppr_run --serve --shards {MESH_SHARDS}: {counts(run.stdout)} against "
              f"--serve's {counts(serve_stdout)}")
    rate = float(re.search(r"\(([\d.]+) req/s", run.stdout).group(1))
    print(f"[sharded] ppr_run --serve --shards {MESH_SHARDS}: exit 0 in {wall:.1f} s, "
          f"{rate:.1f} req/s, {placement[0]!r}; its count lines = --serve's ({card})")
    return dict(wall_s=wall, req_per_s=rate, stdout=run.stdout)


def sharded_phase(torch, np, graphs, dev, card, serve_stdout):
    """Phase 10: (a) the kernel on shard streams, (b) the meshed served path,
    (c) early exit, (d) deltas, (e) adaptive precision, (f) the paper's
    envelope, (g) the driver.  ``launches`` counts coo_spmv over (b)'s
    meshed served passes."""
    t0 = time.perf_counter()
    shards, rows = _shard_kernels(torch, np, graphs, dev, card)
    t1 = time.perf_counter()
    service, launches = _sharded_service(torch, np, graphs, dev, card)
    t2 = time.perf_counter()
    early = _sharded_early_exit(torch, np, graphs["pl_2e5"], dev, card)
    deltas = _sharded_deltas(torch, np, graphs["gnp_2e5"], dev, card)
    auto = _sharded_auto(torch, np, graphs["gnp_2e5"], dev, card)
    t3 = time.perf_counter()
    envelope = _paper_envelope(torch, np, dev, card)
    t4 = time.perf_counter()
    driver = _sharded_driver(np, dev, card, serve_stdout)
    wall = time.perf_counter() - t0
    print(f"[sharded] phase 10 took {wall:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c)-(e) {t3 - t2:.1f}, (f) {t4 - t3:.1f}, (g) {time.perf_counter() - t4:.1f}); "
          f"coo_spmv launches on the served path {launches}")
    torch.cuda.empty_cache()
    return dict(shards=shards, rows=rows, service=service, early_exit=early, deltas=deltas,
                auto=auto, envelope=envelope,
                driver={k: v for k, v in driver.items() if k != "stdout"},
                driver_stdout=driver["stdout"], wall_s=wall, launches=launches)


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


def _lm_timings(torch, row, kernel, library):
    """An LM kernel row's ``ms`` and ``device_ms`` (the spans of the PPR
    rows) and its library call's ``library_ms`` and ``library_device_ms``."""
    row["ms"] = _time_ms(torch, kernel)
    row["device_ms"] = _time_ms(torch, kernel, hide_host=True)
    row["library_ms"] = _time_ms(torch, library)
    row["library_device_ms"] = _time_ms(torch, library, hide_host=True)


def _split_sweep(torch, name, call, want, tol, planned, steps):
    """The kernel with its K split forced to 1, half, the planned count and
    twice it (within [1, steps]): each held to the plain version, timed as a
    call (``ms``) and on the device (``device_ms``)."""
    from unittest import mock

    from repro_torch.kernels import fixed_matmul

    sweep = {}
    for s in sorted({1, max(1, planned // 2), planned, min(steps, 2 * planned)}):
        with mock.patch.object(fixed_matmul, "plan_splits", lambda *_, s=s: s):
            _check_close(torch, f"{name} at {s} splits", call(), want, tol)
            sweep[s] = dict(ms=_time_ms(torch, call),
                            device_ms=_time_ms(torch, call, hide_host=True))
    return sweep


# the tensor-core kernel of each library, by a part of its mangled name
TC_KERNELS = {"flash_attention": "flash_attention_tc_kernel",
              "fixed_matmul": "quantized_matmul_tc_kernel"}


def tensor_core_report(torch):
    """ptxas' registers, shared memory and spills of every kernel in the two
    tensor-core libraries, and the count of HGMMA (wgmma) instructions in
    each kernel's SASS where the toolkit has cuobjdump.  Fails if a bf16
    kernel has no HGMMA, or if the head_dim 256 attention kernel spills."""
    import re
    from repro_torch.kernels import _build

    report = {}
    for lib in TC_KERNELS:
        fn = None
        for line in _build.build_log(lib).splitlines():
            hit = re.search(r"Compiling entry function '(\w+)'", line)
            if hit:
                fn = hit.group(1)
                report[fn] = dict(library=lib)
            elif fn and "spill" in line:
                spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
                report[fn]["spill_bytes"] = sum(spills)
            elif fn and "registers" in line:
                report[fn]["ptxas"] = line.split("info    :")[-1].strip()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.is_file():
        for lib in TC_KERNELS:
            so = _build.build_all((lib,))[lib]
            sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                                  text=True, timeout=300).stdout
            fn = None
            for line in sass.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                    report.setdefault(fn, dict(library=lib))["hgmma"] = 0
                elif fn and "HGMMA" in line:
                    report[fn]["hgmma"] += 1
    else:
        print(f"[tensor-cores] {cuobjdump} not found: HGMMA not counted")
    for fn, r in sorted(report.items()):
        print(f"[tensor-cores] {fn}: {r.get('ptxas', '')}; spill bytes "
              f"{r.get('spill_bytes')}; HGMMA {r.get('hgmma', 'not counted')}")
    for lib, part in TC_KERNELS.items():
        tc = {fn: r for fn, r in report.items() if part in fn}
        if not tc:
            _fail(f"no {part} in the ptxas report of {lib}")
        if cuobjdump.is_file() and any(r.get("hgmma", 0) == 0 for r in tc.values()):
            _fail(f"{part}: a bf16 kernel with no HGMMA instruction")
    d256 = [r for fn, r in report.items() if "flash_attention_tc_kernelILi256E" in fn]
    if not d256 or d256[0].get("spill_bytes") != 0:
        _fail(f"the head_dim 256 attention kernel spills or is missing: {d256}")
    return report


def lm_kernel_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.core.quantization import quantize_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.fixed_matmul import (K_STEP, TILE_M, TILE_N, cta_slots,
                                                  plan_splits, quantized_matmul_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                     flash_attention_gqa_plain)

    report = tensor_core_report(torch)
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
            row = dict(
                kernel="flash_attention", case=name, domain=dom, max_abs_err=err,
                shape=dict(B=b, S=s, H=h, KV=kv, d=d, causal=causal, window=window),
                plain_ms=_time_ms(torch, lambda: flash_attention_gqa_plain(q, k, v, **kw),
                                  repeats=5),
                library="F.scaled_dot_product_attention", library_max_abs_diff=lib_diff,
                bound_ms=bound, bound_by=by)
            _lm_timings(torch, row, lambda: flash_attention_gqa(q, k, v, **kw), library)
            rows.append(row)
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
            slots = cta_slots(a.device, dt == torch.bfloat16)
            splits = plan_splits(m, n, kdim, K_STEP[dt], slots)
            row = dict(
                kernel="quantized_matmul", case=name, domain=dom, max_abs_err=err,
                shape=dict(M=m, K=kdim, N=n), splits=splits, cta_slots=slots,
                plain_ms=_time_ms(torch, lambda: quantized_matmul_plain(a, qw.q, qw.scale)),
                library="(a @ w_q.to(a.dtype)) * scale", bound_ms=bound, bound_by=by)

            def kernel():
                return ops.quantized_matmul(a, qw.q, qw.scale)

            _lm_timings(torch, row, kernel, lambda: (a @ qw.q.to(a.dtype)) * qw.scale)
            w_cast = qw.q.to(dt)      # the library's GEMM alone, on weights cast before
            row["gemm_device_ms"] = _time_ms(torch, lambda: a @ w_cast, hide_host=True)
            del w_cast
            if -(-m // TILE_M) * -(-n // TILE_N) < slots:    # the planner could split
                row["split_sweep"] = _split_sweep(
                    torch, f"quantized_matmul {name} {dom}", kernel, want,
                    LM_TOL["quantized_matmul"][dom], splits, -(-kdim // K_STEP[dt]))
            rows.append(row)
            del a, got, want
    torch.cuda.empty_cache()
    for r in rows:
        split = (f" splits {r['splits']} (of {r['cta_slots']} CTA slots)"
                 if "splits" in r else "")
        gemm = (f"; its GEMM alone on cast weights {r['gemm_device_ms']:.4f}"
                if "gemm_device_ms" in r else "")
        print(f"[lm-kernels] {r['kernel']} {r['case']} {r['domain']}{split}: ms {r['ms']:.4f} "
              f"device_ms {r['device_ms']:.4f} plain {r['plain_ms']:.4f} library "
              f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f}"
              f"{gemm}) bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}, {r['bound_ms'] / r['device_ms']:.1%} "
              f"of device_ms) max abs err {r['max_abs_err']:.3e}")
        for s, t in r.get("split_sweep", {}).items():
            print(f"[lm-kernels]   {r['case']} {r['domain']} forced to {s} splits: "
                  f"ms {t['ms']:.4f} device_ms {t['device_ms']:.4f}")
    return rows, report


# ---------------------------------------------------------------------------
# phase 7: gemma-2b served at full width
# ---------------------------------------------------------------------------
LOGIT_TOL = dict(rtol=2e-3, atol=2e-4)   # the reference's decode-vs-forward tolerance
# (d): a serving shape — a full wave of 1,024-token prompts, 128 new tokens each
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_PASSES = 32, 1024, 128, 3


def _greedy(torch, api, params, prompt, n_new, max_len, logits_out=None):
    """Per-request greedy decode; returns (tokens, top-2 logit gap per step),
    and appends each step's logits to ``logits_out`` where given."""
    cache = api.init_cache(1, max_len)
    logits, cache = api.prefill(params, {"tokens": prompt[None]}, cache)
    toks, gaps, pos = [], [], prompt.shape[0]
    for _ in range(n_new):
        if logits_out is not None:
            logits_out.append(logits[0])
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
    from repro_torch.kernels.fixed_matmul import quantized_matmul_plain
    from repro_torch.kernels.flash_attention import flash_attention_gqa, flash_attention_gqa_plain
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
    f32_counts = launch_counts()
    # the same layer in bfloat16 through the tensor-core kernels, each call
    # held to its plain version on the same inputs
    bf = torch.bfloat16
    q16, k16, v16, x16 = (t.to(bf) for t in (q, k, v, x2))
    errs16 = {"flash_attention": _check_close(
        torch, "layer-0 flash_attention bf16", flash_attention_gqa(q16, k16, v16, causal=True),
        flash_attention_gqa_plain(q16, k16, v16, causal=True),
        LM_TOL["flash_attention"]["bf16"])}

    def qmm16(a, n):
        got = qmm(a, n)
        errs16[n] = _check_close(torch, f"layer-0 quantized_matmul {n} bf16", got,
                                 quantized_matmul_plain(a, qw[n].q, qw[n].scale),
                                 LM_TOL["quantized_matmul"]["bf16"])
        return got

    h16 = (act_fn(qmm16(x16, "w_gate"), cfg32.act) * qmm16(x16, "w_up")).to(bf)
    qmm16(h16, "w_down")
    torch.cuda.synchronize()
    path_counts = launch_counts()
    bf16_counts = {n: path_counts[n] - f32_counts[n] for n in path_counts}
    for name in ("flash_attention", "quantized_matmul"):
        if f32_counts[name] == 0 or bf16_counts[name] == 0:
            _fail(f"the LM path launched {name} no time in float32 or in bfloat16")
    print(f"[lm] (b) layer 0 in bf16 through the tensor-core kernels vs their plain "
          f"versions, max abs err: {errs16}; launches f32 {f32_counts}, bf16 {bf16_counts}")
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
    out.update(attend_max_abs_err=att_err, int8_mlp_rel_l2=mlp_rel, launches=path_counts,
               launches_f32=f32_counts, launches_bf16=bf16_counts, bf16_max_abs_err=errs16)
    del x, q, k, v, ref, att, m, m_ref, qw, x2, q16, k16, v16, x16, h16
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
# phase 11: the LM families at full width
# ---------------------------------------------------------------------------
# arch, layers on the card (None: all of them), bf16 serving prompt, float32
# check prompt.  mixtral's 32 layers hold 187 GB of float32 masters and
# moonshot's 48 hold 112 GB, against the card's 80 GB: 8 layers each.
FAMILY_CASES = [("gemma3-4b", None, 2048, 1536),
                ("mixtral-8x7b", 8, 1024, 512),
                ("moonshot-v1-16b-a3b", 8, 1024, 512),
                ("mamba2-1.3b", None, 1024, 512),
                ("zamba2-1.2b", None, 1024, 512)]
FAMILY_BATCH, FAMILY_NEW, FAMILY_PASSES = 8, 64, 2
WINDOW_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_windowed_cache.py:42
MOE_TOL = dict(rtol=2e-4, atol=2e-5)       # tests/test_moe.py:46
SSD_TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_ssd.py:44, chunked vs naive
MOE_TOKENS, SSD_LEN, SSD_CHUNK = 512, 1024, 256


def _timed(torch, fn, sink):
    """``fn`` with its host-clock ms, to a synchronize, appended to ``sink``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        return r
    return run


def _nbytes(cache) -> int:
    if isinstance(cache, dict):
        return sum(_nbytes(v) for v in cache.values())
    if isinstance(cache, list):
        return sum(_nbytes(v) for v in cache)
    return cache.numel() * cache.element_size()


class _PinnedRoutes:
    """``models.moe.route`` pinned to the forward pass's experts.

    Forward over S + n tokens and prefill over S (or a decode step over 1)
    compute each token's router logits in GEMMs of other shapes, so their
    float32 gates differ in the last bits, and where a token's k-th and
    (k+1)-th gates lie that close (64 experts, top-6, 8 layers: a few
    tokens), the two paths route it differently and its output moves by
    ~1e-3.  Inside ``record()`` each call's experts are kept; inside
    ``replay(start)`` a call takes the recorded experts of the same tokens,
    with gate values from its own gates, and fails unless every route it
    overrides is such a tie: the gates it swaps within ``tol``."""

    def __init__(self, torch, moe, tol=1e-5):
        self.torch, self.moe, self.tol = torch, moe, tol
        self.calls, self.start, self.n, self.pinned = [], None, 0, 0

    def __enter__(self):
        self.route, self.moe.route = self.moe.route, self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def at(self, start):
        self.start, self.n = start, 0

    def _route(self, x, router, cfg):
        torch = self.torch
        val, idx = self.route(x, router, cfg)
        if self.start is None:
            self.calls.append(idx)
            return val, idx
        want = self.calls[self.n][:, self.start:self.start + x.shape[1]]
        self.n += 1
        gates = torch.softmax((x @ router.to(x.dtype)).to(torch.float32), dim=-1)
        for b, t in ((idx.sort(-1).values != want.sort(-1).values).any(-1)).nonzero().tolist():
            own, pin = set(idx[b, t].tolist()), set(want[b, t].tolist())
            gap = float(gates[b, t, sorted(own - pin)].max() - gates[b, t, sorted(pin - own)].min())
            if gap > self.tol:
                _fail(f"{cfg.name}: token {self.start + t} routes to {sorted(own)} here and "
                      f"to {sorted(pin)} in forward, gates {gap:.3e} apart (no tie)")
            self.pinned += 1
        top = gates.gather(-1, want)
        return top / top.sum(-1, keepdim=True).clamp_min(1e-9), want


def _cached_logits(api, params, toks, s, steps, window_cache=False, pins=None):
    """Prefill ``toks[:, :s]``, then ``steps`` decode steps; the logits of
    each and the cache's bytes.  ``pins``: MoE routes pinned to forward's."""
    cache = api.init_cache(toks.shape[0], s + steps, window_cache=window_cache)
    if pins:
        pins.at(0)
    logits, cache = api.prefill(params, {"tokens": toks[:, :s]}, cache)
    outs = [logits]
    for t in range(steps):
        if pins:
            pins.at(s + t)
        logits, cache = api.decode_step(params, toks[:, s + t:s + t + 1], s + t, cache)
        outs.append(logits)
    return outs, _nbytes(cache)


def _decode_vs_forward(torch, np, api, params, cfg, s, rng):
    """(1) at B = 1: prefill ``s`` tokens and decode 4 (16 where a local
    window binds), each step's logits against forward's over a length n that
    ``ssd_chunked`` takes (a multiple of 256); MoE routes pinned to
    forward's at float32 ties (``_PinnedRoutes``).

    Forward itself rounds by length on CUDA (a softmax row or a scan of
    another size associates its sum otherwise), and a deep random-init SSM
    stack amplifies those ~1e-7 seeds: so forward over ``s`` tokens is
    compared with forward over n at position s − 1 (the floor), prefill's
    logits with forward over ``s`` (the same shapes) within the reference's
    tolerance, and each step with forward over n within that tolerance or,
    where the floor exceeds it, within twice the floor.  Returns the decode
    logits, the tokens, the full cache's bytes and the errors."""
    from repro_torch.models import moe

    steps = 16 if any(0 < w < s for w in cfg.layer_pattern) else 4
    n = -(-(s + steps) // 256) * 256
    toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
    pins = _PinnedRoutes(torch, moe) if cfg.num_experts else None
    with pins or contextlib.nullcontext():
        full = api.forward(params, {"tokens": toks})
        if pins:
            pins.at(0)
        short = api.forward(params, {"tokens": toks[:, :s]})[:, -1]
        dec, nbytes = _cached_logits(api, params, toks, s, steps, pins=pins)
    same = float((dec[0] - short).abs().max())
    floor = float((full[:, s - 1] - short).abs().max())
    if not torch.allclose(dec[0], short, **LOGIT_TOL):
        _fail(f"{cfg.name} f32: prefill's logits differ from forward over the same "
              f"{s} tokens by {same:.3e} (rtol {LOGIT_TOL['rtol']}, atol {LOGIT_TOL['atol']})")
    err = 0.0
    for t, got in enumerate(dec):
        want = full[:, s - 1 + t]
        e = float((got - want).abs().max())
        err = max(err, e)
        if not (torch.allclose(got, want, **LOGIT_TOL) or e <= 2 * floor):
            _fail(f"{cfg.name} f32: decode step {t} differs from forward by {e:.3e} "
                  f"(rtol {LOGIT_TOL['rtol']}, atol {LOGIT_TOL['atol']}; forward's own "
                  f"floor between {s} and {n} tokens {floor:.3e})")
    del full
    return dec, toks, nbytes, dict(err=err, same_length_err=same, length_floor=floor,
                                   pinned=pins.pinned if pins else 0)


def _near_tie(torch, gates, k, tol) -> bool:
    """Whether the first k+1 sorted gates of a token hold two within ``tol``
    (a top-k that two float32 routers may order differently)."""
    top = torch.sort(gates, descending=True).values[:k + 1]
    return bool((top[:-1] - top[1:]).min() <= tol)


def _moe_dispatch(torch, np, params, cfg, toks):
    """(3) layer 0's MoE on its real inputs (B = 1, S = 512), at the config's
    capacity factor and at 0.5: the card's routing equals the CPU port's
    outside float32 near-ties, the card's COO dispatch of its gates is
    array-equal to the CPU's of the same gates, and moe_ffn is within
    2e-4 / 2e-5 of the same routing run in float64 on the card."""
    from repro_torch.models import moe
    from repro_torch.models.attention import attention
    from repro_torch.models.common import norm

    dev = params.embed.device
    blk = params.layers[0]
    h = params.embed_tokens(torch.as_tensor(toks[:, :MOE_TOKENS], device=dev).long(), cfg)
    a = attention(norm(h, blk["ln1"], cfg.norm), blk["attn"], cfg, window=cfg.layer_pattern[0])
    if cfg.post_norms:
        a = norm(a, blk["post_ln1"], cfg.norm)
    mi = norm(h + a, blk["ln2"], cfg.norm)
    p, e, k = blk["moe"], cfg.num_experts, cfg.experts_per_token
    mi_c, router_c = mi.cpu(), p["router"].cpu()
    gates = torch.softmax((mi @ p["router"]).float(), -1)[0].cpu()
    gates_c = torch.softmax((mi_c @ router_c).float(), -1)[0]
    gate_err = float((gates - gates_c).abs().max())
    out = dict(gate_max_abs_err=gate_err)
    for cf in (cfg.moe_capacity_factor, 0.5):
        cap = moe._capacity(MOE_TOKENS, cfg, cf)
        val, idx = moe.route(mi, p["router"], cfg)
        _, idx_c = moe.route(mi_c, router_c, cfg)
        differ = (idx.cpu() != idx_c).any(-1)[0].nonzero().flatten().tolist()
        for t in differ:
            if not _near_tie(torch, gates_c[t], k, 4 * gate_err):
                _fail(f"{cfg.name} layer 0: the card routes token {t} to "
                      f"{idx[0, t].tolist()}, the CPU to {idx_c[0, t].tolist()}, "
                      f"with no gate tie within {4 * gate_err:.2e}")
        got = moe.dispatch(idx, val, cap, e, torch.float32)
        want = moe.dispatch(idx.cpu(), val.cpu(), cap, e, torch.float32)
        for name, g_, w_ in zip(("slots", "token ids", "gate values"), got, want):
            if not torch.equal(g_.cpu(), w_):
                _fail(f"{cfg.name} layer 0, capacity factor {cf}: the card's dispatch "
                      f"{name} differ from the CPU's")
        slot, ts, gs = got
        dropped = int((want[0] == e * cap).sum())
        if cf < 1 and not dropped:
            _fail(f"{cfg.name}: capacity factor {cf} dropped no token")
        y = moe.moe_ffn(mi, p, cfg, capacity_factor=cf)
        p64 = {n: t.double() for n, t in p.items()}
        y64 = moe.combine(moe.experts(mi.double(), p64, cfg, cap, slot, ts), slot, ts,
                          gs.double(), MOE_TOKENS)
        del p64
        err = float((y.double() - y64).abs().max())
        if not torch.allclose(y.double(), y64, **MOE_TOL):
            _fail(f"{cfg.name} layer 0: moe_ffn at capacity factor {cf} is {err:.3e} "
                  f"from float64 (rtol {MOE_TOL['rtol']}, atol {MOE_TOL['atol']})")
        out[f"cf_{cf}"] = dict(capacity=cap, dropped=dropped, entries=MOE_TOKENS * k,
                               route_near_ties=len(differ), f64_max_abs_err=err)
    return out


def _ssd_scan(torch, np, cfg, dev):
    """(4) ``ssd_chunked`` at one mamba2 layer's width (B = 1, S = 1,024,
    chunks of 256) in float32 against the step-by-step recurrence in float64
    on the card; inputs drawn as ``tests/test_ssd.py`` draws them."""
    from repro_torch.models.ssm import ssd_chunked

    rng = np.random.default_rng(11)
    b, s, h, p, n = 1, SSD_LEN, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dt, A, B, C = (torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((b, s, h, p)), rng.random((b, s, h)) * 0.5, -rng.random(h),
        rng.standard_normal((b, s, 1, n)), rng.standard_normal((b, s, 1, n))))
    y, final = ssd_chunked(*(a.float() for a in (x, dt, A, B, C)), SSD_CHUNK)
    state = torch.zeros((b, h, p, n), dtype=torch.float64, device=dev)
    ys = torch.zeros((b, s, h, p), dtype=torch.float64, device=dev)
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * A[None])[..., None, None]
                 + (dt[:, t][..., None] * x[:, t])[..., None]
                 * B[:, t].repeat_interleave(h, 1)[:, :, None, :])
        ys[:, t] = torch.einsum("bhpn,bhn->bhp", state, C[:, t].repeat_interleave(h, 1))
    errs = [float((y.double() - ys).abs().max()), float((final.double() - state).abs().max())]
    if not (torch.allclose(y.double(), ys, **SSD_TOL)
            and torch.allclose(final.double(), state, **SSD_TOL)):
        _fail(f"{cfg.name}: ssd_chunked is {errs} (y, final state) from the float64 "
              f"recurrence (rtol {SSD_TOL['rtol']}, atol {SSD_TOL['atol']})")
    return dict(heads=h, head_dim=p, state=n, length=s, chunk=SSD_CHUNK,
                y_max_abs_err=errs[0], final_max_abs_err=errs[1],
                y_max_abs=float(ys.abs().max()))


def _served_equals_greedy(torch, np, api, params, cfg, floor, rng):
    """(5) ``ServingEngine``'s tokens (3 requests of 8 tokens, 5 new, one
    wave) against per-request greedy decoding (B = 1).  The engine's logits
    for each request, up to its first differing token, must equal greedy's
    as check (1) holds decode to forward (the reference's tolerance, or
    twice forward's own ``floor``); a token may then differ only where
    greedy's top-2 gap is within twice that measured difference (the least
    gap two logit vectors that far apart can order otherwise).  Returns the
    smallest gap and the largest difference."""
    from repro_torch.serving import Request, ServingEngine

    seen = []

    def keep(fn):
        def run(*a, **kw):
            logits, cache = fn(*a, **kw)
            seen.append(logits)
            return logits, cache
        return run

    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for _ in range(3)]
    served = ServingEngine(api._replace(prefill=keep(api.prefill),
                                        decode_step=keep(api.decode_step)),
                           params, batch_size=3, max_len=64).serve(
        [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    min_gap, worst = float("inf"), 0.0
    for i, p in enumerate(prompts):
        own = []
        manual, gaps = _greedy(torch, api, params, p, 5, 64, logits_out=own)
        min_gap = min(min_gap, min(gaps))
        err = 0.0
        for t, (x, y) in enumerate(zip(served[i], manual)):
            err = max(err, float((seen[t][i] - own[t]).abs().max()))
            if not (torch.allclose(seen[t][i], own[t], **LOGIT_TOL) or err <= 2 * floor):
                _fail(f"{cfg.name}: the engine's logits for request {i} at step {t} are "
                      f"{err:.3e} from per-request greedy's")
            if x != y:
                print(f"[families] {cfg.name} request {i} step {t}: engine {x} vs greedy "
                      f"{y}, top-2 logit gap {gaps[t]:.3e}, logits {err:.3e} apart")
                if gaps[t] > 2 * err:
                    _fail(f"{cfg.name}: ServingEngine tokens differ from per-request greedy")
                break     # a tie within the error; later tokens may differ
        worst = max(worst, err)
    return min_gap, worst


def _busy_share(torch, run):
    """Device-busy share of one ``run()`` under ``torch.profiler`` (device
    activity only): the union of the kernels' intervals over the pass's host
    clock, from a synchronize to a synchronize.  Reads the raw Kineto events
    (an LM pass makes ~10^6; building ``prof.events()`` takes minutes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter_ns() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and not e.is_user_annotation())
    busy, cur_s, cur_e = 0, None, None
    for a, b in dev:
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    if not dev:
        _fail("the profiled pass recorded no device event")
    return dict(window_ms=window / 1e6, device_busy_ms=busy / 1e6,
                device_busy_share=busy / window, device_events=len(dev))


def _serve_bf16(torch, np, api16, params, cfg, prompt, rng, window_cache=False):
    """bf16 serving: one wave of FAMILY_BATCH requests of ``prompt`` tokens,
    FAMILY_NEW new tokens each; a warm-up, FAMILY_PASSES timed passes and one
    under ``torch.profiler``; with ``window_cache`` one more timed pass on
    rolling buffers."""
    import dataclasses
    import functools

    from repro_torch.serving import Request, ServingEngine

    prefill_ms, decode_ms = [], []
    api_t = api16._replace(prefill=_timed(torch, api16.prefill, prefill_ms),
                           decode_step=_timed(torch, api16.decode_step, decode_ms))
    b, n_new = FAMILY_BATCH, FAMILY_NEW
    engine = ServingEngine(api_t, params, batch_size=b, max_len=prompt + n_new)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, prompt).astype(np.int32),
                    max_new_tokens=n_new) for i in range(b)]
    engine.serve([dataclasses.replace(r, max_new_tokens=4) for r in reqs])  # warm-up
    prefill_ms.clear()
    decode_ms.clear()
    times = []
    for _ in range(FAMILY_PASSES):
        t = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if (sum(len(r) for r in res.values()) != b * n_new
                or not all(0 <= x < cfg.padded_vocab for r in res.values() for x in r)):
            _fail(f"{cfg.name} bf16 serving did not return {n_new} in-vocabulary tokens "
                  f"per request")
    per = [b * n_new / t for t in times]
    out = dict(batch=b, prompt=prompt, new_tokens=n_new, passes=FAMILY_PASSES,
               tokens_per_s=b * n_new * FAMILY_PASSES / sum(times),
               tokens_per_s_pass_range=[min(per), max(per)], pass_s=times,
               prefill_ms=prefill_ms[:],
               decode_step_ms_p50=float(np.percentile(decode_ms, 50)),
               decode_step_ms_p95=float(np.percentile(decode_ms, 95)),
               decode_steps=len(decode_ms))
    t0 = time.perf_counter()
    out["profile"] = _busy_share(torch, lambda: engine.serve(reqs))
    out["profile_s"] = time.perf_counter() - t0
    if window_cache:
        decode_ms.clear()
        api_w = api_t._replace(init_cache=functools.partial(api16.init_cache,
                                                            window_cache=True))
        res_w = ServingEngine(api_w, params, batch_size=b, max_len=prompt + n_new).serve(reqs)
        out["window_cache_decode_step_ms_p50"] = float(np.percentile(decode_ms, 50))
        out["window_cache_tokens_differing"] = sum(
            x != y for i in res for x, y in zip(res[i], res_w[i]))
    return out


def lm_families_phase(torch, np, dev):
    """Phase 11: gemma3-4b, mixtral-8x7b, moonshot-v1-16b-a3b, mamba2-1.3b
    and zamba2-1.2b at full width (mixtral and moonshot cut to 8 layers),
    float32 masters drawn on the card from seed 0: the float32 checks, then
    bf16 serving timed."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    out = {}
    for arch, layers, prompt, s_check in FAMILY_CASES:
        t_model = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        full_layers = cfg.num_layers
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers,
                                      layer_pattern=cfg.layer_pattern[:layers])
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        api32 = build_model(cfg32, device=dev)
        t0 = time.perf_counter()
        params = api32.init_params(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        r = dict(layers=cfg.num_layers, full_layers=full_layers, parameters=n_params,
                 f32_gb=n_params * 4 / 1e9, init_s=time.perf_counter() - t0)
        print(f"[families] {arch}: {cfg.num_layers} of {full_layers} layers, {n_params} "
              f"parameters, {r['f32_gb']:.2f} GB float32, drawn in {r['init_s']:.2f} s")
        rng = np.random.default_rng(19)
        # (1) decode against forward; MoE without capacity drops (capacity
        # factor E, as the reference's smoke configs): at 1.25 a forward over
        # S + n tokens and a prefill over S drop different tokens
        api_chk = api32
        if cfg.num_experts:
            api_chk = build_model(dataclasses.replace(
                cfg32, moe_capacity_factor=float(cfg.num_experts)), device=dev)
        dec, toks, full_bytes, chk = _decode_vs_forward(torch, np, api_chk, params, cfg32,
                                                        s_check, rng)
        err = chk["err"]
        r.update(decode_vs_forward=chk, check_prompt=s_check, check_steps=len(dec) - 1)
        print(f"[families] {arch} (1) f32, B=1, prompt {s_check}: {len(dec) - 1} decode "
              f"steps vs forward, max abs err {err:.3e}; prefill vs forward over the same "
              f"{s_check} tokens {chk['same_length_err']:.3e}; forward's own floor between "
              f"{s_check} and {-(-(s_check + len(dec) - 1) // 256) * 256} tokens "
              f"{chk['length_floor']:.3e}"
              + (f"; {chk['pinned']} routes pinned at float32 gate ties"
                 if cfg.num_experts else ""))
        # (2) the rolling window cache against the full one, where a window
        # binds (gemma3-4b's 1,024; mixtral's 4,096 exceeds these lengths)
        binds = any(0 < w < s_check for w in cfg.layer_pattern)
        if binds:
            win, win_bytes = _cached_logits(api_chk, params, toks, s_check, len(dec) - 1,
                                            window_cache=True)
            werr = max(float((a - b).abs().max()) for a, b in zip(dec, win))
            for t, (a, b) in enumerate(zip(dec, win)):
                if not torch.allclose(b, a, **WINDOW_TOL):
                    _fail(f"{arch}: window_cache=True logits at step {t} differ from the "
                          f"full cache's by {werr:.3e}")
            r.update(window_cache_max_abs_err=werr, cache_bytes_full=full_bytes,
                     cache_bytes_window=win_bytes)
            print(f"[families] {arch} (2) window_cache=True vs full over prefill + "
                  f"{len(dec) - 1} steps (the buffers wrap): max abs err {werr:.3e}; "
                  f"cache bytes {win_bytes} vs {full_bytes} (max_len {s_check + len(dec) - 1})")
            del win
        del dec
        # (3) MoE dispatch on layer 0's inputs
        if cfg.num_experts:
            del api_chk
            r["moe"] = _moe_dispatch(torch, np, params, cfg32, toks)
            for cf in (cfg.moe_capacity_factor, 0.5):
                m = r["moe"][f"cf_{cf}"]
                print(f"[families] {arch} (3) layer-0 MoE, S={MOE_TOKENS}, capacity factor "
                      f"{cf} (capacity {m['capacity']}): dispatch on the card = the CPU's; "
                      f"{m['dropped']} of {m['entries']} entries dropped; moe_ffn vs "
                      f"float64 max abs err {m['f64_max_abs_err']:.3e}; "
                      f"{m['route_near_ties']} near-tie routes")
        # (4) the SSD scan
        if cfg.ssm_state and not cfg.shared_attn_every:
            r["ssd"] = _ssd_scan(torch, np, cfg32, dev)
            print(f"[families] {arch} (4) ssd_chunked, {r['ssd']['heads']} heads x "
                  f"{r['ssd']['head_dim']}, state {r['ssd']['state']}, S={SSD_LEN}, chunk "
                  f"{SSD_CHUNK}, f32 vs float64 recurrence: max abs err "
                  f"{r['ssd']['y_max_abs_err']:.3e} (max |y| {r['ssd']['y_max_abs']:.1f}), "
                  f"final state {r['ssd']['final_max_abs_err']:.3e}")
        # (5) served tokens against per-request greedy
        gap, gerr = _served_equals_greedy(torch, np, api32, params, cfg32,
                                          chk["length_floor"], rng)
        r.update(greedy_min_top2_gap=gap, greedy_logits_max_abs_err=gerr)
        print(f"[families] {arch} (5) f32 engine (B=3) == per-request greedy (B=1): "
              f"logits {gerr:.3e} apart, smallest top-2 gap {gap:.3e}")
        r["checks_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["checks_s"] = time.perf_counter() - t_model
        # bf16 serving, timed
        api16 = build_model(cfg, device=dev)
        sv = _serve_bf16(torch, np, api16, params, cfg, prompt, rng, window_cache=binds)
        sv["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["serving"] = sv
        prof = sv["profile"]
        print(f"[families] {arch} bf16 serve: {FAMILY_BATCH} requests in one wave, prompt "
              f"{prompt}, {FAMILY_NEW} new tokens, {FAMILY_PASSES} timed passes: "
              f"{sv['tokens_per_s']:.1f} tokens/s (passes {sv['tokens_per_s_pass_range'][0]:.1f}"
              f"-{sv['tokens_per_s_pass_range'][1]:.1f}); prefill (B={FAMILY_BATCH}, "
              f"S={prompt}) {statistics.median(sv['prefill_ms']):.2f} ms; decode step p50/p95 "
              f"{sv['decode_step_ms_p50']:.2f}/{sv['decode_step_ms_p95']:.2f} ms; device busy "
              f"{100 * prof['device_busy_share']:.1f}% of a profiled pass "
              f"({prof['device_busy_ms']:.1f} of {prof['window_ms']:.1f} ms); peak memory "
              f"{sv['peak_mem_gb']:.2f} GB")
        if "window_cache_decode_step_ms_p50" in sv:
            print(f"[families] {arch} bf16 decode step p50 {sv['decode_step_ms_p50']:.2f} ms "
                  f"with the full cache, {sv['window_cache_decode_step_ms_p50']:.2f} ms with "
                  f"window_cache=True ({sv['window_cache_tokens_differing']} of "
                  f"{FAMILY_BATCH * FAMILY_NEW} served tokens differ between the two)")
        r["wall_s"] = time.perf_counter() - t_model
        print(f"[families] {arch} took {r['wall_s']:.1f} s: checks {r['checks_s']:.1f}, "
              f"the profiled pass {sv['profile_s']:.1f}")
        out[arch] = r
        del params, api32, api16
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[families] phase 11 took {out['wall_s']:.1f} s ("
          + ", ".join(f"{a} {out[a]['wall_s']:.1f}" for a, *_ in FAMILY_CASES) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 12: whisper-medium and phi-3-vision served, and the training path
# ---------------------------------------------------------------------------
# (a): the two models whole; float32 checks at B = 1 over CHECK_PROMPT
# tokens and CHECK_STEPS decode steps; bf16 serving of ENC_BATCH requests of
# ENC_PROMPT tokens, ENC_NEW new tokens each
CHECK_PROMPT, CHECK_STEPS = 64, 4
ENC_BATCH, ENC_PROMPT, ENC_NEW, ENC_PASSES = 8, 32, 64, 2
VLM_PROMPT = 512
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_train.py:57
ILL = 1e-6       # √v̂ below this: Adam's direction m̂/(√v̂+ε) is ill-conditioned
TRAIN_STEPS, WHISPER_STEPS = 20, 10


def _encdec_batch(np, cfg, b, toks, rng):
    """tokens and the stub frontend's frames or patches (float32, as the
    reference's smoke tests draw them)."""
    batch = {"tokens": toks}
    if cfg.enc_len:
        batch["frames"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model), np.float32)
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model), np.float32)
    return batch


def _encdec_checks(torch, np, api, params, cfg, rng):
    """(a) float32, B = 1: prefill against forward over the same tokens with
    the frames or patches, CHECK_STEPS decode steps against forward, and
    whisper's cross cache against the encoder output's wk / wv."""
    from repro_torch.models.transformer import run_encoder

    s, n, p = CHECK_PROMPT, CHECK_STEPS, cfg.num_patches
    toks = rng.integers(0, cfg.vocab_size, (1, s + n)).astype(np.int32)
    batch = _encdec_batch(np, cfg, 1, toks, rng)
    full = api.forward(params, batch)
    same = api.forward(params, dict(batch, tokens=toks[:, :s]))[:, -1]
    cache = api.init_cache(1, p + s + n)
    logits, cache = api.prefill(params, dict(batch, tokens=toks[:, :s]), cache)
    out = dict(prefill_vs_forward_same_length=float((logits - same).abs().max()))
    if not torch.allclose(logits, same, **LOGIT_TOL):
        _fail(f"{cfg.name} f32: prefill differs from forward over the same {s} tokens by "
              f"{out['prefill_vs_forward_same_length']:.3e}")
    err = 0.0
    for t in range(n + 1):
        want = full[:, p + s - 1 + t]
        e = float((logits - want).abs().max())
        err = max(err, e)
        if not torch.allclose(logits, want, **LOGIT_TOL):
            _fail(f"{cfg.name} f32: step {t} differs from forward by {e:.3e} (rtol "
                  f"{LOGIT_TOL['rtol']}, atol {LOGIT_TOL['atol']})")
        if t < n:
            logits, cache = api.decode_step(params, toks[:, s + t:s + t + 1], p + s + t, cache)
    out["decode_vs_forward"] = err
    if cfg.enc_layers:
        enc = run_encoder(params, torch.as_tensor(batch["frames"], device=full.device), cfg)
        shape = (1, cfg.enc_len, cfg.num_kv_heads, cfg.head_dim)
        cross = 0.0
        for block, c in zip(params.layers, cache):
            for name, w in (("ck", "wk"), ("cv", "wv")):
                want = (enc @ block["cross"][w]).reshape(shape)
                cross = max(cross, float((c[name] - want).abs().max()))
                if not torch.allclose(c[name], want, rtol=1e-6, atol=1e-6):
                    _fail(f"{cfg.name}: the cross cache {name} is not the encoder output's "
                          f"{w} projection")
        out["cross_cache_max_abs_err"] = cross
    return out


def _whisper_serve(torch, np, api16, params, cfg, rng):
    """(a) whisper bf16: ENC_BATCH requests, frames [B, 1500, 1024], a greedy
    prefill / decode_step loop of ENC_NEW tokens; a warm-up, ENC_PASSES timed
    passes and one profiled."""
    b, s, n = ENC_BATCH, ENC_PROMPT, ENC_NEW
    batch = _encdec_batch(np, cfg, b, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                          rng)
    batch["frames"] = torch.as_tensor(batch["frames"], device=params.embed.device)
    prefill_ms, decode_ms = [], []
    prefill = _timed(torch, api16.prefill, prefill_ms)
    decode = _timed(torch, api16.decode_step, decode_ms)

    def serve(new):
        logits, cache = prefill(params, batch, api16.init_cache(b, s + new))
        out = []
        for t in range(new):
            cur = logits.argmax(-1)[:, None]
            out.append(cur)
            logits, cache = decode(params, cur, s + t, cache)
        return torch.cat(out, 1)

    serve(4)
    prefill_ms.clear()
    decode_ms.clear()
    times = []
    for _ in range(ENC_PASSES):
        t = time.perf_counter()
        toks = serve(n)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if toks.shape != (b, n) or not bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()):
            _fail("whisper bf16 serving did not return in-vocabulary tokens")
    return _serve_stats(torch, np, times, prefill_ms, decode_ms, lambda: serve(n),
                        dict(batch=b, prompt=s, frames=cfg.enc_len, new_tokens=n))


def _serve_stats(torch, np, times, prefill_ms, decode_ms, run, shape):
    b, n = shape["batch"], shape["new_tokens"]
    per = [b * n / t for t in times]
    out = dict(shape, passes=len(times), tokens_per_s=b * n * len(times) / sum(times),
               tokens_per_s_pass_range=[min(per), max(per)], pass_s=times,
               prefill_ms=prefill_ms[:], decode_step_ms_p50=float(np.percentile(decode_ms, 50)),
               decode_step_ms_p95=float(np.percentile(decode_ms, 95)),
               decode_steps=len(decode_ms))
    out["profile"] = _busy_share(torch, run)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _vlm_serve(torch, np, api16, params, cfg, rng):
    """(a) phi-3-vision bf16: ``ServingEngine`` with ENC_BATCH text requests of
    VLM_PROMPT tokens (the engine passes no patches), then one wave through
    ``prefill`` with 576 patches a request and ENC_NEW decode steps."""
    import dataclasses

    from repro_torch.serving import Request, ServingEngine

    b, n = ENC_BATCH, ENC_NEW
    prefill_ms, decode_ms = [], []
    api_t = api16._replace(prefill=_timed(torch, api16.prefill, prefill_ms),
                           decode_step=_timed(torch, api16.decode_step, decode_ms))
    engine = ServingEngine(api_t, params, batch_size=b, max_len=VLM_PROMPT + n)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, VLM_PROMPT).astype(np.int32),
                    max_new_tokens=n) for i in range(b)]
    engine.serve([dataclasses.replace(r, max_new_tokens=4) for r in reqs])
    prefill_ms.clear()
    decode_ms.clear()
    times = []
    for _ in range(ENC_PASSES):
        t = time.perf_counter()
        res = engine.serve(reqs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if sum(len(r) for r in res.values()) != b * n:
            _fail("phi-3-vision bf16 serving did not return every token")
    out = _serve_stats(torch, np, times, prefill_ms, decode_ms, lambda: engine.serve(reqs),
                       dict(batch=b, prompt=VLM_PROMPT, new_tokens=n))
    # one wave with patches: positions 0..575 are the image, the prompt follows
    s, p = ENC_PROMPT, cfg.num_patches
    batch = _encdec_batch(np, cfg, b, rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                          rng)
    prefill_ms.clear()
    decode_ms.clear()
    logits, cache = api_t.prefill(params, batch, api16.init_cache(b, p + s + n))
    for t in range(n):
        logits, cache = api_t.decode_step(params, logits.argmax(-1)[:, None], p + s + t, cache)
    if not bool(torch.isfinite(logits).all()):
        _fail("phi-3-vision: the wave with patches returned non-finite logits")
    out["with_patches"] = dict(batch=b, patches=p, prompt=s, new_tokens=n,
                               prefill_ms=prefill_ms[0],
                               decode_step_ms_p50=float(np.percentile(decode_ms, 50)))
    return out


def encdec_serving(torch, np, dev):
    """Phase 12(a): whisper-medium and phi-3-vision-4.2b whole."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = {}
    for arch, serve in (("whisper-medium", _whisper_serve), ("phi-3-vision-4.2b", _vlm_serve)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        api32 = build_model(cfg32, device=dev, remat=False)
        params = api32.init_params(torch.Generator(dev).manual_seed(0))
        n_params = sum(p.numel() for p in params.parameters())
        rng = np.random.default_rng(20)
        r = dict(parameters=n_params, f32_gb=n_params * 4 / 1e9,
                 checks=_encdec_checks(torch, np, api32, params, cfg32, rng))
        c = r["checks"]
        print(f"[encdec] {arch}: {n_params} parameters ({r['f32_gb']:.2f} GB float32); f32, "
              f"B=1, prompt {CHECK_PROMPT}: prefill vs forward over the same tokens "
              f"{c['prefill_vs_forward_same_length']:.3e}, {CHECK_STEPS} decode steps vs forward "
              f"max abs err {c['decode_vs_forward']:.3e}"
              + (f"; cross cache vs the encoder's wk/wv {c['cross_cache_max_abs_err']:.3e}"
                 if "cross_cache_max_abs_err" in c else ""))
        api16 = build_model(cfg, device=dev, remat=False)
        sv = serve(torch, np, api16, params, cfg, rng)
        r["serving"] = sv
        prof = sv["profile"]
        print(f"[encdec] {arch} bf16: {sv['batch']} requests, prompt {sv['prompt']}"
              + (f", frames [{sv['batch']}, {sv['frames']}, {cfg.d_model}]" if "frames" in sv
                 else ", text-only through ServingEngine")
              + f", {sv['new_tokens']} new tokens, {sv['passes']} timed passes: "
              f"{sv['tokens_per_s']:.1f} tokens/s (passes {sv['tokens_per_s_pass_range'][0]:.1f}"
              f"-{sv['tokens_per_s_pass_range'][1]:.1f}); prefill "
              f"{statistics.median(sv['prefill_ms']):.2f} ms; decode step p50/p95 "
              f"{sv['decode_step_ms_p50']:.2f}/{sv['decode_step_ms_p95']:.2f} ms; device busy "
              f"{100 * prof['device_busy_share']:.1f}% of a profiled pass; peak memory "
              f"{sv['peak_mem_gb']:.2f} GB")
        if "with_patches" in sv:
            w = sv["with_patches"]
            print(f"[encdec] {arch} bf16 wave with patches: B={w['batch']}, {w['patches']} "
                  f"patches + {w['prompt']} tokens: prefill {w['prefill_ms']:.2f} ms, decode "
                  f"step p50 {w['decode_step_ms_p50']:.2f} ms")
        r["wall_s"] = time.perf_counter() - t0
        out[arch] = r
        del params, api32, api16
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _hold_params(torch, got, want, nu, lr, step, opt):
    """Parameters after a step against a reference's: (b)'s tolerance, except
    where √v̂ < ILL (Adam's direction ill-conditioned: there |Δp| ≤ 2.5·lr
    a step).  Returns (max abs err outside those, count of those)."""
    err, ill_n = 0.0, 0
    b2c = 1 - opt.b2 ** step
    for n, w in want.items():
        g = got[n].detach().to(w.device)
        d = (g - w).abs()
        off = d > TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * w.abs()
        ill = torch.sqrt(nu[n].to(w.device) / b2c) < ILL
        if bool((off & ~ill).any()):
            _fail(f"parameter {n}: {float(d[off & ~ill].max()):.3e} from the reference after "
                  f"{step} step(s) where Adam is well-conditioned")
        if bool((d[off] > 2.5 * lr * step).any()):
            _fail(f"parameter {n}: an ill-conditioned element moved beyond 2.5·lr a step")
        ill_n += int(off.sum())
        err = max(err, float(d[~off].max()) if bool((~off).any()) else 0.0)
    return err, ill_n


def train_numerics(torch, np, dev):
    """Phase 12(b): gemma-2b at full width cut to 2 global layers, float32,
    B = 2, S = 64 from ``synthetic_batch``: the card's loss and every
    gradient leaf against the CPU's, the parameters after one AdamW step,
    remat on = off, 2 microbatches = 1, and the residuals of
    ``grad_compress_bits=12``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.optimizer import adamw_update, init_opt_state

    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2, layer_pattern=(0, 0),
                              compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    lr = float(opt.lr)
    cpu = torch.device("cpu")
    init = build_model(cfg, device=dev).init_params(torch.Generator(dev).manual_seed(0))
    init = {n: t.cpu() for n, t in init.state_dict().items()}
    dcfg = DataConfig(seq_len=64, global_batch=2)
    out = dict(parameters=sum(p.numel() for p in init.values()))

    def fresh(device):
        """The parameters drawn on the card from seed 0, copied to ``device``."""
        params = Transformer(cfg, device="meta")
        params.load_state_dict({n: t.to(device, copy=True) for n, t in init.items()},
                               assign=True)
        return params.requires_grad_(True)

    def loss_and_grads(device, remat):
        api = build_model(cfg, device=device, remat=remat)
        params = fresh(device)
        loss = api.loss_fn(params, synthetic_batch(cfg, dcfg, 0, device))
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return params, float(loss.detach()), grads

    t0 = time.perf_counter()
    card_params, card_loss, card_grads = loss_and_grads(dev, True)
    cpu_params, cpu_loss, cpu_grads = loss_and_grads(cpu, True)
    out["loss"] = dict(card=card_loss, cpu=cpu_loss)
    if abs(card_loss - cpu_loss) > TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(cpu_loss):
        _fail(f"gemma-2b x2 loss on the card {card_loss} vs the CPU {cpu_loss}")
    gerr = 0.0
    for n, w in cpu_grads.items():
        g = card_grads[n].cpu()
        gerr = max(gerr, float((g - w).abs().max()))
        if not torch.allclose(g, w, **TRAIN_TOL):
            _fail(f"gemma-2b x2: the gradient of {n} on the card is "
                  f"{float((g - w).abs().max()):.3e} from the CPU's")
    out["grad_max_abs_err"] = gerr
    # one AdamW step on each, from the same gradients' own device copies
    card_state, cpu_state = init_opt_state(card_params), init_opt_state(cpu_params)
    adamw_update(opt, card_grads, card_state, card_params)
    adamw_update(opt, cpu_grads, cpu_state, cpu_params)
    perr, ill = _hold_params(torch, dict(card_params.named_parameters()),
                             {n: p.detach() for n, p in cpu_params.named_parameters()},
                             cpu_state.nu, lr, 1, opt)
    out["adamw_step"] = dict(max_abs_err=perr, ill_conditioned_elements=ill)
    del cpu_params, cpu_grads, cpu_state, card_state
    # remat on against off, on the card
    _, loss_off, grads_off = loss_and_grads(dev, False)
    rerr = max(float((card_grads[n] - g).abs().max()) for n, g in grads_off.items())
    if not all(torch.allclose(card_grads[n], g, **TRAIN_TOL) for n, g in grads_off.items()):
        _fail(f"gemma-2b x2: remat=True gradients {rerr:.3e} from remat=False")
    out["remat_vs_not"] = dict(loss=[card_loss, loss_off], grad_max_abs_err=rerr)
    del card_params, card_grads, grads_off
    # 2 microbatches against 1, and compression at 12 bits, through make_train_step
    api = build_model(cfg, device=dev, remat=True)
    batch = synthetic_batch(cfg, dcfg, 0, dev)
    states = {}
    for m, bits in ((1, 0), (2, 0), (1, 12)):
        step = make_train_step(api.loss_fn, opt, microbatches=m, grad_compress_bits=bits)
        states[m, bits] = step(init_train_state(fresh(dev), compress=bits > 0), batch)
    (s1, m1), (s2, m2) = states[1, 0], states[2, 0]
    merr, mill = _hold_params(torch, dict(s2.params.named_parameters()),
                              {n: p.detach() for n, p in s1.params.named_parameters()},
                              s1.opt.nu, lr, 1, opt)
    out["microbatches_2_vs_1"] = dict(loss=[float(m1["loss"]), float(m2["loss"])],
                                      max_abs_err=merr, ill_conditioned_elements=mill)
    sc, mc = states[1, 12]
    rmax = max(float(r.abs().max()) for r in sc.residual.values())
    if not rmax <= 2.0 ** -12 or not np.isfinite(float(mc["loss"])):
        _fail(f"grad_compress_bits=12: a residual of {rmax} exceeds 2^-12")
    out["compress_12"] = dict(residual_max=rmax, loss=float(mc["loss"]))
    out["wall_s"] = time.perf_counter() - t0
    del states, sc, s1, s2
    print(f"[train] (b) gemma-2b at full width cut to 2 layers ({out['parameters']} "
          f"parameters), f32, B=2, S=64: loss card {card_loss:.6f} vs CPU {cpu_loss:.6f}; "
          f"every gradient leaf within rtol 2e-4 / atol 2e-5 (max abs err {gerr:.3e}); after "
          f"one AdamW step the parameters within it (max abs err {perr:.3e}; {ill} "
          f"ill-conditioned elements held to 2.5·lr); remat on vs off {rerr:.3e}; 2 "
          f"microbatches vs 1 {merr:.3e} ({mill} ill-conditioned); compress 12 bits: max "
          f"residual {rmax:.3e} <= 2^-12 ({out['wall_s']:.1f} s)")
    return out


def _train_driver(np, args, timeout=300):
    """``python -m repro_torch.launch.train`` as a subprocess, its ``done:``,
    ``timing:`` and ``profile:`` lines parsed."""
    import os
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--ckpt-dir", ckpt,
               "--log-every", "5", "--profile"] + args
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                             env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=str(ROOT))
        wall = time.perf_counter() - t0
    if run.returncode:
        _fail(f"launch.train {' '.join(args)} exited {run.returncode}: {run.stderr[-2000:]}")
    done = re.search(r"done: ran (\d+) steps, first loss ([-\d.naif]+) last ([-\d.naif]+)",
                     run.stdout)
    timing = re.search(r"step ms p50 ([\d.]+) \(min ([\d.]+), max ([\d.]+)\), ([\d,.]+) "
                       r"tokens/s at the p50, peak memory ([\d.]+) GB, first step done "
                       r"([\d.]+) s after start", run.stdout)
    prof = re.search(r"profile: wall ([\d.]+) ms, device busy ([\d.]+) ms \(([\d.]+)%\)",
                     run.stdout)
    if not (done and timing and prof):
        _fail(f"launch.train {' '.join(args)}: missing done/timing/profile lines:\n"
              f"{run.stdout[-2000:]}")
    first, last = float(done.group(2)), float(done.group(3))
    if not (np.isfinite(first) and np.isfinite(last)):
        _fail(f"launch.train {' '.join(args)}: non-finite loss {first} / {last}")
    return dict(args=args, steps=int(done.group(1)), first_loss=first, last_loss=last,
                step_ms_p50=float(timing.group(1)), step_ms_min=float(timing.group(2)),
                step_ms_max=float(timing.group(3)),
                tokens_per_s=float(timing.group(4).replace(",", "")),
                peak_mem_gb=float(timing.group(5)), first_step_done_s=float(timing.group(6)),
                profile_wall_ms=float(prof.group(1)),
                profile_busy_ms=float(prof.group(2)), busy_share=float(prof.group(3)) / 100,
                wall_s=wall, stdout=run.stdout)


def train_full_width(np, card):
    """Phase 12(c): ``launch.train`` at its defaults (batch 8, seq 256, bf16,
    remat): gemma-2b 20 steps, again with 2 microbatches and 12-bit
    compression, and whisper-medium 10 steps; no checkpoint is written."""
    runs = {"gemma-2b": ["--arch", "gemma-2b", "--steps", str(TRAIN_STEPS),
                         "--save-every", str(TRAIN_STEPS + 1)],
            "gemma-2b m2 c12": ["--arch", "gemma-2b", "--steps", str(TRAIN_STEPS),
                                "--save-every", str(TRAIN_STEPS + 1), "--microbatches", "2",
                                "--compress-bits", "12"],
            "whisper-medium": ["--arch", "whisper-medium", "--steps", str(WHISPER_STEPS),
                               "--save-every", str(WHISPER_STEPS + 1)]}
    out = {}
    for name, args in runs.items():
        r = _train_driver(np, args)
        out[name] = r
        print(f"[train] (c) {name}, batch 8, seq 256, bf16, remat: {r['steps']} steps, step "
              f"ms p50 {r['step_ms_p50']:.2f} (min {r['step_ms_min']:.2f}, max "
              f"{r['step_ms_max']:.2f}), {r['tokens_per_s']:.1f} tokens/s; loss "
              f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}; peak memory "
              f"{r['peak_mem_gb']:.2f} GB; device busy {100 * r['busy_share']:.1f}% of a "
              f"profiled step ({r['profile_busy_ms']:.1f} of {r['profile_wall_ms']:.1f} ms); "
              f"first step done {r['first_step_done_s']:.1f} s after launch.train started, "
              f"subprocess {r['wall_s']:.1f} s ({card})")
    return out


def train_resume(torch, np, dev):
    """Phase 12(d): ``run_resumable`` at smoke size on the card: a failure at
    step 4 after the checkpoint at step 3, then a resume, against an
    uninterrupted run of 6 steps, parameters within (b)'s tolerance (the
    embedding's backward sums by atomics: no raw equality) except
    ill-conditioned elements."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.training import (
        AdamWConfig,
        FaultConfig,
        init_train_state,
        make_train_step,
        run_resumable,
    )

    cfg = dataclasses.replace(smoke_config(get_config("gemma-2b")), compute_dtype="float32",
                              num_layers=2, layer_pattern=(0, 0))
    api = build_model(cfg, device=dev)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(api.loss_fn, opt)

    def init():
        return init_train_state(api.init_params(torch.Generator(dev).manual_seed(0)))

    def batch_fn(s):
        return synthetic_batch(cfg, DataConfig(16, 4), s, dev)

    ref = init()
    for s in range(6):
        ref, _ = step(ref, batch_fn(s))
    with tempfile.TemporaryDirectory() as d:
        fault = FaultConfig(ckpt_dir=d, save_every=3, max_steps=6)
        try:
            run_resumable(fault, init, step, batch_fn, fail_at_step=4)
            _fail("run_resumable did not raise at fail_at_step")
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        state, steps_run, _ = run_resumable(fault, init, step, batch_fn)
    if steps_run != 3 or int(state.opt.step) != 6:
        _fail(f"the resume ran {steps_run} steps to step {int(state.opt.step)}, not 3 to 6")
    err, ill = _hold_params(torch, dict(state.params.named_parameters()),
                            {n: p.detach() for n, p in ref.params.named_parameters()},
                            ref.opt.nu, opt.lr, 6, opt)
    print(f"[train] (d) resume at smoke size on the card: failure at step 4, resumed from "
          f"the step-3 checkpoint, 3 steps run; parameters vs an uninterrupted run max abs "
          f"err {err:.3e} ({ill} ill-conditioned elements)")
    return dict(max_abs_err=err, ill_conditioned_elements=ill, steps_run=steps_run)


def encdec_train_phase(torch, np, dev, card):
    """Phase 12: (a) whisper-medium and phi-3-vision served, (b) the training
    numerics at gemma-2b's width, (c) ``launch.train`` at full width, (d)
    resume on the card."""
    import gc

    t0 = time.perf_counter()
    out = dict(serving=encdec_serving(torch, np, dev))
    t1 = time.perf_counter()
    out["numerics"] = train_numerics(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    out["full_width"] = train_full_width(np, card)
    t3 = time.perf_counter()
    out["resume"] = train_resume(torch, np, dev)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[train] phase 12 took {out['wall_s']:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c) {t3 - t2:.1f}, (d) {time.perf_counter() - t3:.1f})")
    return out


# ---------------------------------------------------------------------------
# phase 13: the sharding rules, the compressed all-reduce, the H100 roofline and
# the dry-run drivers
# ---------------------------------------------------------------------------
PHASE13_BUDGET_S = 60
# counted train FLOPs / 6·N·T at phase 12(c)'s shape: remat recomputes the
# layers' forward (4/3 on them), and the float32 head over gemma-2b's 256,000
# rows runs three products a step that 6·N·T counts at the embedding's share
TRAIN_FLOP_FACTOR = (1.0, 1.5)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _gemma_x2():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("gemma-2b"), num_layers=2, layer_pattern=(0, 0),
                               compute_dtype="float32")


def sharding_hooks(torch, np, dev):
    """(a) gemma-2b at full width cut to 2 layers, float32, phase 12(b)'s seed
    and batch: its parameters as DTensors on a 1×1 mesh of a one-rank NCCL
    group, ``set_sharding_context(mesh)``, the loss, every gradient leaf and
    the parameters after one AdamW step against the same step unsharded on
    the card; ``compressed_psum`` over the group at 12 fractional bits; a
    save of the stepped parameters and the step, restored onto the mesh with
    ``shardings=``."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.quantization import truncate_to_grid
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, checkpoint
    from repro_torch.training.optimizer import adamw_update, init_opt_state

    cfg = _gemma_x2()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    api = build_model(cfg, device=dev, remat=True)
    batch = synthetic_batch(cfg, DataConfig(seq_len=64, global_batch=2), 0, dev)

    def step(params, bt):
        loss = api.loss_fn(params, bt)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        state = init_opt_state(params)
        adamw_update(opt, grads, state, params)
        return loss.detach(), grads, state

    def fresh():
        return api.init_params(torch.Generator(dev).manual_seed(0)).requires_grad_(True)

    want_params = fresh()
    want_loss, want_grads, _ = step(want_params, batch)
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        params = shd.distribute_params(fresh(), mesh, cfg)
        specs = shd.batch_specs(batch, mesh)
        dbatch = {k: shd.distribute(v, mesh, specs[k], k) for k, v in batch.items()}
        shd.set_sharding_context(mesh)
        try:
            with implicit_replication():
                loss, grads, state = step(params, dbatch)
        finally:
            shd.set_sharding_context(None)
        diffs = {"loss": float((loss.full_tensor() - want_loss).abs())}
        gmax = 0.0
        for n, w in want_grads.items():
            g = grads[n].full_tensor()
            gmax = max(gmax, float((g - w).abs().max()))
            if not torch.allclose(g, w, **TRAIN_TOL):
                _fail(f"(a) the sharded gradient of {n} is {float((g - w).abs().max()):.3e} "
                      f"from the unsharded one")
        pmax = 0.0
        for n, w in want_params.named_parameters():
            w = w.detach()
            p = params.get_parameter(n).full_tensor().detach()
            pmax = max(pmax, float((p - w).abs().max()))
            if not torch.allclose(p, w, **TRAIN_TOL):
                _fail(f"(a) after one AdamW step the sharded {n} is "
                      f"{float((p - w).abs().max()):.3e} from the unsharded one")
        if abs(diffs["loss"]) > TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(float(want_loss)):
            _fail(f"(a) the sharded loss is {diffs['loss']:.3e} from the unsharded one")
        diffs.update(grad_max_abs=gmax, param_max_abs=pmax)
        out["step_vs_unsharded"] = diffs
        # compressed_psum over the NCCL group: q = trunc(g + r), r' = g + r − q
        gen = torch.Generator(dev).manual_seed(1)
        for n, g in want_grads.items():
            r = torch.randn(g.shape, generator=gen, device=dev) * 2.0 ** -14
            red, r2 = compressed_psum(g, r, "data", 12, mesh=mesh)
            q = truncate_to_grid(g + r, 12)
            if not (torch.equal(red, q) and torch.equal(r2, (g + r) - q)):
                _fail(f"(a) compressed_psum of {n} over the NCCL group is not "
                      f"truncate_to_grid with residual g + r - q, bit for bit")
        out["compressed_psum_leaves"] = len(want_grads)
        # save, then restore onto the mesh
        named = dict(params.named_parameters())
        saved = {"params": {n: p.full_tensor() for n, p in named.items()}, "step": state.step}
        like = {"params": {n: torch.zeros_like(t) for n, t in saved["params"].items()},
                "step": torch.zeros_like(state.step)}
        shardings = {"params": {n: (mesh, p.placements) for n, p in named.items()},
                     "step": None}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save(d, 1, saved)
            got = checkpoint.restore(d, 1, like, shardings=shardings)
        for n, t in saved["params"].items():
            r = got["params"][n]
            if tuple(r.placements) != tuple(named[n].placements) or \
                    not torch.equal(r.full_tensor(), t):
                _fail(f"(a) restore(shardings=) of {n} is not the saved tensor bit for bit")
        if not torch.equal(got["step"], saved["step"]):
            _fail("(a) restore(shardings=) of the step is not the saved one")
        out["save_restore_s"] = time.perf_counter() - t0
        out["save_restore_bytes"] = sum(t.numel() * 4 for t in saved["params"].values())
    finally:
        dist.destroy_process_group()
    print(f"[dist] (a) gemma-2b x2 f32 on a 1x1 NCCL mesh under set_sharding_context: loss, "
          f"{len(want_grads)} gradient leaves and the parameters after one AdamW step "
          f"within rtol 2e-4 / atol 2e-5 of the unsharded step (max abs diff loss "
          f"{out['step_vs_unsharded']['loss']:.3e}, gradients {gmax:.3e}, parameters "
          f"{pmax:.3e}); compressed_psum at 12 bits = truncate_to_grid, residual g + r - q, "
          f"bit for bit on {len(want_grads)} leaves; save + restore(shardings=) of "
          f"{out['save_restore_bytes'] / 1e9:.2f} GB bit for bit in "
          f"{out['save_restore_s']:.1f} s")
    return out


def roofline_vs_card(torch, measured, card):
    """(b) ``structured_roofline`` on a 1×1 mesh (device type "cuda", a
    one-rank "fake" group: the count runs on meta tensors) of gemma-2b's
    train step at phase 12(c)'s shape and its decode step at phase 7(d)'s,
    each beside the p50 this run measured there."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.structured import structured_roofline

    cfg = get_config("gemma-2b")
    cases = {"train": (ShapeConfig("train_b8_s256", "train", 256, 8),
                       measured.get("train_step_ms_p50"), "phase 12(c) step ms p50"),
             "decode": (ShapeConfig("decode_b32_c1152", "decode",
                                    SERVE_PROMPT + SERVE_NEW, SERVE_BATCH),
                        measured.get("decode_step_ms_p50"), "phase 7(d) decode step ms p50")}
    out = {}
    with fake_group(1):
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        for name, (shape, ms, what) in cases.items():
            t0 = time.perf_counter()
            r = structured_roofline(cfg, shape, mesh)
            r["count_s"] = time.perf_counter() - t0
            bound_ms = 1e3 * max(r["compute_s_by_dtype"], r["memory_s"], r["collective_s"])
            r.update(measured_ms=ms, measured=what, bound_ms=bound_ms,
                     share_of_bound=(bound_ms / ms) if ms else None,
                     flop_factor=r["flops_per_device"] / r["model_flops"])
            out[name] = r
            seen = "not measured" if ms is None else f"{ms:.2f}"
            share = "n/a" if ms is None else f"{r['share_of_bound']:.4f}"
            print(f"[roofline] (b) gemma-2b {name} B={shape.global_batch} "
                  f"{'S' if name == 'train' else 'cache'}={shape.seq_len} bf16 on 1x1: FLOPs "
                  f"{r['flops_per_device']:.4e} ({r['flop_factor']:.4f} x the analytic "
                  f"{'6' if name == 'train' else '2'}NT; float32 "
                  f"{r['flops_by_dtype'].get('float32', 0.0):.4e}), unfused bytes "
                  f"{r['bytes_per_device']:.4e}; terms compute {r['compute_s'] * 1e3:.3f} ms "
                  f"(by type {r['compute_s_by_dtype'] * 1e3:.3f}), memory "
                  f"{r['memory_s'] * 1e3:.3f} ms, collective {r['collective_s'] * 1e3:.3f} ms, "
                  f"bottleneck {r['bottleneck']}; {what} {seen}, share of the bound "
                  f"{share} ({card}); counted in {r['count_s']:.1f} s")
    lo, hi = TRAIN_FLOP_FACTOR
    if not lo <= out["train"]["flop_factor"] <= hi:
        _fail(f"(b) gemma-2b's counted train FLOPs are {out['train']['flop_factor']:.4f} x "
              f"6NT, outside [{lo}, {hi}]")
    return out


def _start_driver(args, out_dir):
    import os

    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m"] + args + ["--out", out_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(SRC)))


def _driver_json(started, args, out_dir, files, timeout=300):
    """Wait for a driver started by ``_start_driver``; its exit code and the
    reference's keys in each of its JSON files."""
    t0, proc = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        _fail(f"(c) {' '.join(args)} exited {proc.returncode}:\n{stdout[-2000:]}\n"
              f"{stderr[-4000:]}")
    recs = {}
    for f, keys in files.items():
        rec = json.loads((Path(out_dir) / f).read_text())
        missing = set(keys) - set(rec)
        if missing:
            _fail(f"(c) {f} lacks the reference's keys {sorted(missing)}")
        recs[f] = rec
    return dict(wall_s=wall, stdout=stdout, records=recs)


def drivers_on_host(np):
    """(c) the dry-run drivers on the card's host, as subprocesses (each its
    own 512-rank "fake" group): ``ppr_dryrun --workload ppr-pod-16m`` and,
    in the budget's place of the full ``train_4k`` cell (whose counted run
    takes ~2 minutes; PERF.md records it), ``dryrun --arch gemma-2b --shape
    decode_32k --mesh single``."""
    import tempfile

    ppr_keys = ["workload", "mesh", "V", "E", "kappa_total", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device", "collectives", "memory_s",
                "collective_s"]
    cell_keys = ["arch", "shape", "mesh", "chips", "opt_level", "params", "active_params",
                 "lower_s", "compile_s", "memory_analysis", "cost_flops", "cost_bytes",
                 "roofline"]
    ppr_args = ["repro_torch.launch.ppr_dryrun", "--workload", "ppr-pod-16m"]
    cell_args = ["repro_torch.launch.dryrun", "--arch", "gemma-2b", "--shape", "decode_32k",
                 "--mesh", "single"]
    out = {}
    with tempfile.TemporaryDirectory() as d:      # both at once: each is mostly start-up
        ppr, cell = _start_driver(ppr_args, d), _start_driver(cell_args, d)
        out["ppr_dryrun"] = _driver_json(ppr, ppr_args, d, {
            f"ppr__ppr-pod-16m__{m}.json": ppr_keys
            for m in ("single_pod_16x16", "multi_pod_2x16x16")})
        out["dryrun"] = _driver_json(cell, cell_args, d, {
            "single_pod_16x16/gemma-2b__decode_32k.json": cell_keys})
    for name, r in out.items():
        for f, rec in r["records"].items():
            terms = rec.get("roofline", rec)
            print(f"[drivers] (c) {name} -> {f}: memory_s {terms['memory_s']:.4e}, "
                  f"collective_s {terms['collective_s']:.4e} (predictions from the H100 "
                  f"constants); subprocess {r['wall_s']:.1f} s")
    return out


def sharding_phase(torch, np, dev, card, measured):
    """Phase 13: (a) the sharding hooks on a real group, (b) the roofline
    beside the card's own steps, (c) the dry-run drivers; ≤ 60 s."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = dict(hooks=sharding_hooks(torch, np, dev))
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["roofline"] = roofline_vs_card(torch, measured, card)
    t2 = time.perf_counter()
    out["drivers"] = drivers_on_host(np)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[dist] phase 13 took {out['wall_s']:.1f} s of its {PHASE13_BUDGET_S} s budget "
          f"((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {time.perf_counter() - t2:.1f})")
    return out


# ---------------------------------------------------------------------------
# phase 14: the examples on the card
# ---------------------------------------------------------------------------
PHASE14_BUDGET_S = 90
EXAMPLE_TRAIN_STEPS = 60
# the clocks in the examples' lines (as tests/test_torch_examples.py masks them)
EXAMPLE_CLOCKS = (
    (r"http://127\.0\.0\.1:\d+", "http://127.0.0.1:<port>"),
    (r"t=\d+\.\d+s", "t=<s>"),
    (r" +\d+(?:\.\d+)? ms\b", " <ms> ms"),
    (r"\(\d+ queries/s", "(<r> queries/s"),
)


def _start_example(name, device, threads=None, args=()):
    """Start ``examples_torch/<name> --device <device>``; a thread waits for
    it (at most 300 s) and stamps its end, so runs side by side each get
    their own wall time."""
    import os
    import threading

    env = dict(os.environ, PYTHONPATH=str(SRC))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    run = dict(t0=time.perf_counter(), proc=subprocess.Popen(
        [sys.executable, str(ROOT / "examples_torch" / name), "--device", device, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT), env=env))

    def wait():
        try:
            run["stdout"], run["stderr"] = run["proc"].communicate(timeout=300)
        except subprocess.TimeoutExpired:
            run["proc"].kill()
            run["stdout"], run["stderr"] = run["proc"].communicate()
        run["t1"] = time.perf_counter()

    run["waiter"] = threading.Thread(target=wait, daemon=True)
    run["waiter"].start()
    return run


def _example_out(run, name, device):
    """Wait for an example started by ``_start_example``: exit 0, its stdout
    and its wall seconds."""
    run["waiter"].join()
    if run["proc"].returncode != 0:
        _fail(f"examples_torch/{name} --device {device} exited {run['proc'].returncode}:\n"
              f"{run['stdout'][-2000:]}\n{run['stderr'][-4000:]}")
    return dict(wall_s=run["t1"] - run["t0"], stdout=run["stdout"])


def _masked_lines(stdout):
    import re

    lines = stdout.splitlines()
    for pattern, repl in EXAMPLE_CLOCKS:
        lines = [re.sub(pattern, repl, line) for line in lines]
    return lines


def _http_burst(lines):
    """The ordinary traffic's lines, the burst's served / shed counts, the
    audit's values and the timeline's event names."""
    import re

    i = next(i for i, line in enumerate(lines) if line.startswith("burst of 32:"))
    served, shed = map(int, re.search(r"(\d+) served .*?(\d+) shed", lines[i]).groups())
    stats = [line.split() for line in lines[i + 2:i + 13]]
    events = [m.group(1) for m in (re.match(r" +t=<s> (\w+)", line) for line in lines) if m]
    return lines[:i], served, shed, stats, events


def examples_phase(card):
    """Phase 14: the five scripts of ``examples_torch/`` as subprocesses on
    the card (the PPR ones one after another, the two LM ones beside them);
    ``quickstart.py``, ``ppr_recommender.py`` and ``http_serving.py`` also
    with ``--device cpu`` (started first, on two threads each, beside the
    card's runs).  The card's PPR lines equal the
    CPU's with the clocks masked (every answer is Q1.25 or Q1.19 raw-exact,
    the shadow NDCG printed to 4 decimals); the HTTP tier's ordinary traffic
    equals the CPU's, and its burst answers all 32 and sheds, then recovers;
    ``serve_lm.py`` serves 10 requests and 60 tokens; ``train_lm.py --steps
    60`` (warm-up 30) ends below its first loss and writes no checkpoint
    (save_every 100)."""
    import re
    import shutil
    import tempfile

    ckpt = Path(tempfile.gettempdir()) / "repro_torch_example_train"
    shutil.rmtree(ckpt, ignore_errors=True)   # a stale checkpoint would resume past --steps
    t0 = time.perf_counter()
    on_cpu = {name: _start_example(name, "cpu", threads=2)
              for name in ("quickstart.py", "ppr_recommender.py", "http_serving.py")}
    # the two LM scripts keep the card busy and the PPR scripts the host:
    # the LM ones run beside the PPR ones, which run one after another
    lm = {"serve_lm.py": _start_example("serve_lm.py", "cuda"),
          "train_lm.py": _start_example("train_lm.py", "cuda",
                                        args=("--steps", str(EXAMPLE_TRAIN_STEPS)))}
    out = {}
    for name in ("quickstart.py", "ppr_recommender.py", "http_serving.py"):
        out[name] = dict(card=_example_out(_start_example(name, "cuda"), name, "cuda"))
    for name, started in lm.items():
        out[name] = dict(card=_example_out(started, name, "cuda"))
    for name, started in on_cpu.items():
        out[name]["cpu"] = _example_out(started, name, "cpu")
    for name in ("quickstart.py", "ppr_recommender.py"):
        gpu, cpu = (_masked_lines(out[name][d]["stdout"]) for d in ("card", "cpu"))
        if gpu != cpu:
            diff = [(g, c) for g, c in zip(gpu, cpu) if g != c][:5]
            _fail(f"examples_torch/{name}: the card's lines differ from the CPU's: {diff} "
                  f"({len(gpu)} / {len(cpu)} lines)")
        out[name]["equal_to_cpu"] = True
    gpu, cpu = (_http_burst(_masked_lines(out["http_serving.py"][d]["stdout"]))
                for d in ("card", "cpu"))
    if gpu[0] != cpu[0]:
        _fail(f"examples_torch/http_serving.py: the ordinary traffic differs: {gpu[0]} / {cpu[0]}")
    for where, (_, served, shed, _, events) in (("card", gpu), ("cpu", cpu)):
        if served + shed != 32 or shed == 0:
            _fail(f"http_serving.py on the {where}: burst {served} served + {shed} shed")
        if not events.index("shed_engaged") < events.index("shed_recovered"):
            _fail(f"http_serving.py on the {where}: timeline {events}")
    out["http_serving.py"].update(
        burst_card=gpu[1:3], burst_cpu=cpu[1:3], events_card=gpu[4], events_cpu=cpu[4],
        audit_equal_to_cpu=gpu[1:] == cpu[1:])
    served = re.search(r"MoE serving: (\d+) requests → (\d+) tokens in ([\d.]+)s",
                       out["serve_lm.py"]["card"]["stdout"])
    if not served or (int(served.group(1)), int(served.group(2))) != (10, 60):
        _fail(f"serve_lm.py: {out['serve_lm.py']['card']['stdout'][-500:]}")
    ran = re.search(r"ran (\d+) steps; loss ([\d.]+) → ([\d.]+)",
                    out["train_lm.py"]["card"]["stdout"])
    if not ran or int(ran.group(1)) != EXAMPLE_TRAIN_STEPS \
            or not float(ran.group(3)) < float(ran.group(2)):
        _fail(f"train_lm.py: {out['train_lm.py']['card']['stdout'][-800:]}")
    if ckpt.exists() and any(ckpt.iterdir()):
        _fail(f"train_lm.py --steps {EXAMPLE_TRAIN_STEPS} wrote a checkpoint: "
              f"{sorted(p.name for p in ckpt.iterdir())}")
    shutil.rmtree(ckpt, ignore_errors=True)
    out["train_lm.py"].update(first_loss=float(ran.group(2)), last_loss=float(ran.group(3)))
    out["wall_s"] = time.perf_counter() - t0
    for name, r in out.items():
        if name == "wall_s":
            continue
        walls = ", ".join(f"{d} {r[d]['wall_s']:.1f} s" for d in ("card", "cpu") if d in r)
        note = ""
        if "equal_to_cpu" in r:
            note = "; lines equal to the CPU's (clocks masked)"
        elif name == "http_serving.py":
            note = (f"; ordinary traffic equal to the CPU's; burst served/shed card "
                    f"{r['burst_card'][0]}/{r['burst_card'][1]}, cpu {r['burst_cpu'][0]}/"
                    f"{r['burst_cpu'][1]}; audit and event order "
                    f"{'equal' if r['audit_equal_to_cpu'] else 'differ'} "
                    f"(card {r['events_card']}, cpu {r['events_cpu']})")
        elif name == "serve_lm.py":
            note = f"; 10 requests, 60 tokens in {served.group(3)} s"
        elif name == "train_lm.py":
            note = (f"; {EXAMPLE_TRAIN_STEPS} steps, loss {r['first_loss']:.3f} -> "
                    f"{r['last_loss']:.3f}, no checkpoint")
        print(f"[examples] {name}: {walls}{note} ({card})")
    print(f"[examples] phase 14 took {out['wall_s']:.1f} s of its {PHASE14_BUDGET_S} s budget")
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

    _load_constants()

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
    rows += topk_phase(torch, np, dev)
    service = service_phase(torch, np, graphs["gnp_2e5"], dev)
    early = early_exit_phase(torch, np, graphs["pl_2e5"], dev)
    t0 = time.perf_counter()
    deltas = delta_phase(torch, np, graphs, dev)
    if deltas["launches"] == 0:
        _fail("the delta phase's served waves launched fused_ppr_iteration no time")
    print(f"[delta] phase took {time.perf_counter() - t0:.1f} s")
    autotune = autotune_phase(torch, np, graphs, dev, card)
    if autotune["launches"] == 0:
        _fail("phase 8's served waves launched fused_ppr_iteration no time")
    for r in rows:      # phase 8 held the float kernel at the shadow's shapes too
        if r["kernel"] == "fused_ppr_iteration" and r["domain"] == "f32":
            shapes = autotune["auto"][r["graph"]]["shadow_shapes"]["max_abs_err"]
            r["max_abs_err"] = max(r["max_abs_err"], *shapes.values())
    obs = observability_phase(torch, np, graphs, dev, card)
    if obs["launches"] == 0:
        _fail("phase 9's served waves launched fused_ppr_iteration no time")
    rows += obs["deep_rows"]
    sharded = sharded_phase(torch, np, graphs, dev, card,
                            autotune["driver_stdout"]["serve"])
    if sharded["launches"] == 0:
        _fail("phase 10's meshed served passes launched coo_spmv no time")
    rows += sharded["rows"]
    spmv_counts = spmv_path_phase(torch, np, graphs["gnp_2e5"], dev)
    lm_rows, tensor_cores = lm_kernel_phase(torch, dev)
    lm = lm_serving_phase(torch, np, dev)
    families = lm_families_phase(torch, np, dev)
    encdec_train = encdec_train_phase(torch, np, dev, card)
    sharding = sharding_phase(torch, np, dev, card, measured={
        "train_step_ms_p50": encdec_train["full_width"]["gemma-2b"]["step_ms_p50"],
        "decode_step_ms_p50": lm["serving_shape"]["decode_step_ms_p50"]})
    examples = examples_phase(card)

    print("[times] kernel graph domain: ms plain_ms bound_ms library_ms "
          "function_bound_ms bound_share | device_ms device_bound_share "
          "library_device_ms | device_ops_per_call (profiles) device_ms_by_kernel")

    def opt(x):
        return "null" if x is None else f"{x:.4f}"

    for r in rows:
        print(f"[times] {r['kernel']} {r['graph']} {r['domain']}"
              f"{'' if 'k' not in r else ' K=' + str(r['k'])}"
              f"{'' if 'shard' not in r else ' shard ' + r['shard']}: {r['ms']:.4f} "
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

    launches = dict(service["launches"],
                    coo_spmv=spmv_counts["coo_spmv"] + sharded["launches"])
    launches_by_path = {"coo_spmv": {"phase 5": spmv_counts["coo_spmv"],
                                     "phase 10": sharded["launches"]},
                        "fused_ppr_iteration": {
        "phase 3": service["launches"]["fused_ppr_iteration"],
        "phase 4b": deltas["launches"],
        "phase 8": autotune["launches"],
        "phase 9": obs["launches"]}}
    launches["fused_ppr_iteration"] += (deltas["launches"] + autotune["launches"]
                                        + obs["launches"])
    sources = {"coo_spmv": ("src/repro_torch/csrc/coo_spmv.cu",
                            "src/repro/kernels/coo_spmv.py:125"),
               "fused_ppr_iteration": ("src/repro_torch/csrc/fused_ppr.cu",
                                       "src/repro/kernels/fused_ppr.py:404"),
               "fused_ppr_dangling_mass": ("src/repro_torch/csrc/fused_ppr.cu",
                                           "src/repro/kernels/fused_ppr.py:365"),
               "topk_select": ("src/repro_torch/csrc/topk_select.cu",
                               "none: lax.top_k in src/repro/ppr_serving/topk.py")}
    launches_source = {
        "coo_spmv": "phase 5: core.spmv.spmv_kernel, and phase 10: sharded served "
                    "path (PPRService on a 4-shard mesh, gnp_2e5 and pl_2e5: each "
                    "iteration's SpMV one call a shard)",
        "fused_ppr_iteration": "phase 3: PPRService served path, phase 4b: "
                               "the waves served after each delta on the refreshed "
                               "streams (gnp_2e5) and warm start (pl_2e5), and "
                               "phase 8: precision='auto' waves with their float32 "
                               "shadow references (gnp_2e5, pl_2e5), the "
                               "unreachable-target waves and the prefetch polls, and "
                               "phase 9: traced waves (tracing off, on and 0.1) and "
                               "the waves the HTTP tier's pump ran on its worker "
                               "thread at K = 16, 32 and 64 (gnp_2e5)",
        "fused_ppr_dangling_mass": "phase 3: PPRService served path, where the "
                                   "dangling fold runs inside fused_ppr_iteration's "
                                   "kernel A and this standalone launch is not made",
        "topk_select": "phase 3: PPRService served path, the fused family's waves "
                       "(one launch a wave, as the single family's are checked to "
                       "make)"}
    kernels = []
    for r in rows:
        src, repl = sources[r["kernel"]]
        suffix = ("" if "k" not in r else f",K={r['k']}") + (
            "" if "shard" not in r else f",shard {r['shard']}") + (
            "" if r["graph"] == "gnp_2e5" else f",{r['graph']}")
        kernels.append(dict(
            name=f"{r['kernel']}[{r['domain']}{suffix}]", route="cuda", source=src,
            replaces=repl, launches=launches[r["kernel"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
            function_bound_ms=r["unpadded_bound_ms"],
            device_ops_per_call=r["device_ops_per_call"], device_ms=r["device_ms"],
            library_device_ms=r["library_device_ms"],
            launches_source=launches_source[r["kernel"]],
            launches_by_path=launches_by_path.get(r["kernel"]), parity="pass"))
    lm_sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                      "src/repro/kernels/flash_attention.py:86"),
                  "quantized_matmul": ("src/repro_torch/csrc/fixed_matmul.cu",
                                       "src/repro/kernels/fixed_matmul.py:42")}
    for r in lm_rows:
        src, repl = lm_sources[r["kernel"]]
        kernels.append(dict(
            name=f"{r['kernel']}[{r['domain']},{r['case']}]", route="cuda", source=src,
            replaces=repl, launches=lm[f"launches_{r['domain']}"][r["kernel"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            device_ms=r["device_ms"], library_device_ms=r["library_device_ms"],
            device_ops_per_call=lm_ops[r["kernel"]],
            launches_source=f"phase 7(b): gemma-2b layer-0 attention and int8 MLP "
                            f"through the kernels' entry points, composed by this "
                            f"script: its {r['domain']} pass",
            parity="pass"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, streams=streams, kernel_rows=rows, service=service,
        early_exit=early, deltas=deltas, autotune=autotune,
        observability={k: v for k, v in obs.items() if k != "deep_rows"},
        sharded={k: v for k, v in sharded.items() if k not in ("rows", "driver_stdout")},
        lm_kernel_rows=lm_rows, tensor_cores=tensor_cores, lm_serving=lm,
        lm_families=families,
        encdec_train=dict(encdec_train, full_width={
            k: {kk: vv for kk, vv in v.items() if kk != "stdout"}
            for k, v in encdec_train["full_width"].items()}),
        train_stdout={k: v["stdout"] for k, v in encdec_train["full_width"].items()},
        sharding=sharding, examples=examples, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
