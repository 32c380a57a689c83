"""End-to-end example: train a ~100M-parameter LM for a few hundred steps, on
the PyTorch port.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--arch gemma-2b]
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu   # plain PyTorch

Uses a ~100M-class reduction of the chosen architecture (real vocab, fewer/
narrower layers), the deterministic synthetic pipeline, AdamW, microbatched
gradient accumulation, and periodic async checkpoints — the full training
substrate on one device.  (``launch/train.py`` runs the full config.)
Counterpart of ``examples/train_lm.py``.  It resumes from the latest
checkpoint in its directory, so a directory left at or past ``--steps``
makes it run no step.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import FULL_ATTN
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import (
    AdamWConfig, FaultConfig, init_train_state, make_train_step, run_resumable,
)

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_example_train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = get_config(args.arch)
    # ~100M params: 4 layers × d_model 512 with the arch's real vocab
    cfg = dataclasses.replace(
        base, num_layers=4, layer_pattern=(FULL_ATTN,) * 4, d_model=512,
        num_heads=8, num_kv_heads=max(1, min(base.num_kv_heads, 8)), head_dim=64,
        d_ff=2048, compute_dtype="float32",
    )
    api = build_model(cfg, device=dev, remat=True)
    print(f"{cfg.name}-100M: {cfg.param_count():,} params (analytic)")

    step_fn = make_train_step(
        api.loss_fn,
        AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps),
        microbatches=2)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)

    def init_state():
        return init_train_state(api.init_params(torch.Generator(dev).manual_seed(0)))

    t0 = time.time()
    log = []

    def on_metrics(s, m):
        log.append(float(m["loss"]))
        if s % 20 == 0:
            tps = args.batch * args.seq * len(log) / (time.time() - t0)
            print(f"step {s:4d}  loss {log[-1]:.4f}  tok/s {tps:,.0f}", flush=True)

    fault = FaultConfig(ckpt_dir=CKPT_DIR, save_every=100, max_steps=args.steps)
    state, n, _ = run_resumable(fault, init_state, step_fn,
                                lambda s: synthetic_batch(cfg, dcfg, s, dev), on_metrics)
    print(f"ran {n} steps; loss {log[0]:.3f} → {log[-1]:.3f}")
    assert log[-1] < log[0], "loss should decrease"


if __name__ == "__main__":
    main()
