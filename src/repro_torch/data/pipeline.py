"""Deterministic synthetic data pipeline (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step): numpy's
``default_rng(SeedSequence([seed, step]))`` draws the tokens, then the
frames, then the patches, in the reference's order, so the port's batches
are array-equal to the reference's.  A restarted job replays exactly its
stream, the fault-tolerance requirement a real (shard, step)-addressed
loader meets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["DataConfig", "synthetic_batch", "data_iterator"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic distribution: zipf-ish over the vocab (realistic token stats)
    zipf_a: float = 1.2


def synthetic_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """{tokens, targets [B, S] int32, [frames [B, enc_len, D] | patches
    [B, P, D] float32]} for ``step``, on ``device`` (``cuda`` unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    v = cfg.vocab_size
    # zipf sample clipped to vocab (cheap approximation of token frequencies)
    raw = rng.zipf(dcfg.zipf_a, size=(dcfg.global_batch, dcfg.seq_len + 1))
    toks = ((raw - 1) % v).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.enc_len:
        batch["frames"] = rng.standard_normal(
            (dcfg.global_batch, cfg.enc_len, cfg.d_model), np.float32)
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal(
            (dcfg.global_batch, cfg.num_patches, cfg.d_model), np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in batch.items()}


def data_iterator(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
                  device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, dcfg, step, device)
        step += 1
