"""End-to-end training driver (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --steps 200 \
        [--smoke] [--seq 512] [--batch 8] [--microbatches 2] \
        [--ckpt-dir DIR] [--compress-bits 0] [--device cuda|cpu] [--profile]
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium --smoke --device cpu

``--arch`` takes every architecture of ``configs/archs.py``.  ``--smoke``
uses the reduced config in float32; otherwise activations run in bf16 over
float32 masters drawn from ``torch.Generator(device).manual_seed(0)`` on the
device, every layer recomputed in the backward pass (remat).  The loop is
resumable: it picks up the latest checkpoint in ``--ckpt-dir`` (default: a
directory named for the arch under the system's temporary directory).

It prints the reference's ``step`` lines every ``--log-every`` steps and its
``done:`` line; then a ``timing:`` line (step ms p50 from the second step
of this invocation on, host clock to a device synchronize; tokens/s at
that p50; the device's peak memory; the seconds from the start of
``main`` to the end of the first step), and with ``--profile`` one more
step under ``torch.profiler`` (not saved): its wall time, the device's
busy time (the union of the kernels' intervals) and the kernels that took
the most device time, read from the raw trace (a train step makes ~10^5
profiler events, and ``key_averages`` over them takes seconds).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import (
    AdamWConfig,
    FaultConfig,
    init_train_state,
    make_train_step,
    run_resumable,
)


def profile_step(run, dev, top: int = 8) -> None:
    """Run ``run`` once under ``torch.profiler`` (device activity only) and
    print its wall time to a synchronize, the device's busy time and share,
    and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        print("profile: not measured (the device is the CPU)")
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
    busy_ns, end = 0, None
    for a, b in sorted((e.start_ns(), e.end_ns()) for e in kernels):
        if end is None or a > end:
            busy_ns += b - a
        elif b > end:
            busy_ns += b - end
        end = b if end is None else max(end, b)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + (e.end_ns() - e.start_ns()) / 1e6, n + 1)
    print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ns / 1e6:.1f} ms "
          f"({100 * busy_ns / 1e6 / wall_ms:.1f}%), {len(kernels)} device operations")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"profile: kernel {ms:9.2f} ms {n:6d}x {name[:90]}")


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compress-bits", type=int, default=0,
                    help="fixed-point gradient compression fractional bits (0=off)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(smoke_config(cfg), compute_dtype="float32")
    dev = resolve_device(args.device)
    api = build_model(cfg, device=dev, remat=True)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                          total_steps=args.steps)
    step_fn = make_train_step(api.loss_fn, opt_cfg, microbatches=args.microbatches,
                              grad_compress_bits=args.compress_bits)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)

    def init_state():
        params = api.init_params(torch.Generator(dev).manual_seed(0))
        return init_train_state(params, compress=args.compress_bits > 0)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    losses, stamps = [], []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        stamps.append(time.perf_counter())
        if step % args.log_every == 0:
            tok_s = args.batch * args.seq * (step + 1) / max(1e-9, time.time() - t0)
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} tok/s {tok_s:,.0f}", flush=True)

    fault = FaultConfig(
        ckpt_dir=args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                               f"repro_torch_train_{args.arch}"),
        save_every=args.save_every, max_steps=args.steps,
    )
    batch_fn = lambda s: synthetic_batch(cfg, dcfg, s, dev)  # noqa: E731
    state, steps_run, stragglers = run_resumable(
        fault, init_state, step_fn, batch_fn, on_metrics=on_metrics)
    print(f"done: ran {steps_run} steps, first loss {losses[0]:.4f} "
          f"last {losses[-1]:.4f}, stragglers {len(stragglers)}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    if step_ms:
        print(f"timing: {len(step_ms)} steps after the first, step ms p50 "
              f"{statistics.median(step_ms):.2f} (min {min(step_ms):.2f}, max "
              f"{max(step_ms):.2f}), {args.batch * args.seq * 1e3 / statistics.median(step_ms):,.1f} "
              f"tokens/s at the p50, peak memory "
              + (f"{peak:.2f} GB" if peak is not None else "not measured (cpu)")
              + f", first step done {stamps[0] - t_start:.1f} s after start", flush=True)
    if args.profile:
        profile_step(lambda: step_fn(state, batch_fn(args.steps)), dev)


if __name__ == "__main__":
    main()
