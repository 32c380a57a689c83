"""Meta-device stand-ins for every (arch × shape) dry-run cell (counterpart
of ``repro.launch.specs``).

Nothing is allocated: parameters are a ``Transformer`` built on the
``meta`` device (the reference's ``jax.eval_shape(init_params)``), the
decode cache comes from ``init_cache`` on ``meta``, and the batch is built
directly, with the reference's shapes and dtypes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import ModelApi, Transformer
from repro_torch.training.optimizer import AdamState
from repro_torch.training.train_loop import TrainState

__all__ = ["META", "batch_specs", "params_specs", "cache_specs", "train_state_specs",
           "decode_specs"]

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training/prefill batch stand-ins (modality frontends are stubs:
    precomputed frame/patch embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    text_s = s - (cfg.num_patches or 0)
    specs["tokens"] = torch.empty((b, text_s), dtype=torch.int32, device=META)
    if shape.kind == "train":
        specs["targets"] = torch.empty((b, s if not cfg.num_patches else text_s),
                                       dtype=torch.int32, device=META)
    if cfg.enc_len:
        specs["frames"] = torch.empty((b, cfg.enc_len, cfg.d_model), device=META)
    if cfg.num_patches:
        specs["patches"] = torch.empty((b, cfg.num_patches, cfg.d_model), device=META)
    return specs


def params_specs(api: ModelApi) -> Transformer:
    """The model's parameters on ``meta`` (float32 masters, undrawn)."""
    return Transformer(api.cfg, None, META)


def cache_specs(api: ModelApi, batch: int, max_len: int) -> Any:
    """``api.init_cache`` of a model built on ``meta``."""
    return api.init_cache(batch, max_len)


def train_state_specs(params) -> TrainState:
    """Parameters (gradients on), AdamW's step and moments shaped and laid out
    like them (a DTensor's zeros keep its placements); no residual."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    dev = next(iter(named.values())).device
    return TrainState(
        params=params,
        opt=AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={k: torch.zeros_like(p) for k, p in named.items()},
                      nu={k: torch.zeros_like(p) for k, p in named.items()}),
        residual=None,
    )


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, api: ModelApi
                 ) -> Tuple[torch.Tensor, int, Any]:
    """(token, pos, cache) stand-ins for one decode step with a seq_len
    cache.  The port's decode step takes ``pos`` as an int; its cost does
    not depend on it (every slot is scored, the invalid ones masked)."""
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device=META)
    return token, shape.seq_len - 1, cache_specs(api, b, shape.seq_len)
