"""Serving launcher: batched greedy decoding with the slot-based engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --requests 32 \
        --batch 32 --prompt-len 1024 --new-tokens 128 --max-len 1152 --profile

``--arch`` takes every decoder-only architecture of ``configs/archs.py``
(dense with global or local-window layers, moe, ssm, hybrid) and
phi-3-vision-4.2b, served text-only (its patches are optional, as in the
reference).  whisper-medium raises ``KeyError: 'frames'``, as the reference's
does: the engine passes prefill only the tokens, and the encoder needs
frames (serve whisper through ``prefill``/``decode_step`` with
``batch["frames"]``).  Weights are drawn from
``torch.Generator(device).manual_seed(0)`` as float32 masters on the device
(``cfg.param_count()`` × 4 bytes: gemma-2b 10.0 GB; mixtral-8x7b 187 GB,
more than one card holds).
``--profile`` serves the requests once more under ``torch.profiler`` and
prints the device's busy share of that pass and its device time by operator
and by kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(smoke_config(cfg), compute_dtype="float32")
    dev = resolve_device(args.device)
    api = build_model(cfg, device=dev)
    params = api.init_params(torch.Generator(dev).manual_seed(0))
    engine = ServingEngine(api, params, batch_size=args.batch, max_len=args.max_len)

    rng = np.random.default_rng(0)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    t0 = time.time()
    results = engine.serve(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:,.1f} tok/s) on {dev}")
    for uid in sorted(results)[:4]:
        print(f"  req {uid}: {results[uid]}")
    if args.profile:
        profile(lambda: engine.serve(reqs), dev)


def profile(run, dev, top: int = 8) -> None:
    """Run ``run`` once under ``torch.profiler``; print the wall time, the
    device's busy time and share, and the ``top`` operators and kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with _profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    operators = [e for e in events if e not in kernels]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} "
          f"device operations")
    for kind, evs in (("operator", operators), ("kernel", kernels)):
        for e in sorted(evs, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
            print(f"profile: {kind} {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x {e.key[:90]}")


if __name__ == "__main__":
    main()
