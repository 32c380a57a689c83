"""Trip-count-correct roofline of one cell (counterpart of
``repro.roofline.structured``).

The reference lowers each component apart (a scanned layer group, the
embed → logits → loss base, the encoder, AdamW) and multiplies by the trip
counts, because XLA's cost analysis counts a ``while`` body once.  The
port's step is eager: a counted run on meta tensors (``CostCounter`` over
DTensors on the mesh) dispatches every layer, so a whole-step count is
already trip-count-correct and needs no per-component lowering:

  train:   mb × [forward (remat) + backward of one microbatch]
           + AdamW (once) + the data-parallel gradient all-reduce (analytic, once)
  prefill: the prefill step (embed, every layer, the K/V cache writes, the
           last position's logits)
  decode:  one decode step against a ``seq_len`` cache

The microbatches are identical programs, so one (the first of the split
batch, ``make_train_step``'s split) is counted and multiplied.
Between the backward and AdamW the gradients are reduced to their
parameters' placements; that reduction is counted (``grad_reduce_bytes``,
for reference) and, as in the reference, replaced in ``collectives`` by the
analytic all-reduce of the per-device f32 gradient bytes × ``grad_ar_scale``
(unlike the reference, only where the data axes hold more than one
device: one data-parallel device reduces nothing).

``overrides`` (the reference's variant hooks): ``sequence_parallel``,
``grad_ar_scale``, ``cache_len`` (window → cache length, decode),
``kv_dtype`` and ``param_dtype`` (decode).  The reference's component
builders (``group``, ``decode_attn_body``) and ``decode_layer_fn`` have no
counterpart here: the port counts the whole step, so they raise.

``count_step`` is the one counting routine: ``launch.dryrun`` writes its
cells from it too, adding only ``memory_analysis`` from the step's
arguments and outputs that it returns.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import MAMBA, ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    axis_sizes,
    batch_specs,
    cache_specs,
    distribute_params,
    distribute_tree,
    param_specs,
    set_sharding_context,
)
from repro_torch.launch import specs as S
from repro_torch.models.transformer import build_model
from repro_torch.roofline.analysis import (
    CostCounter,
    model_flops_forward,
    model_flops_train,
    roofline,
)
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.train_loop import _split

__all__ = ["structured_roofline", "count_step", "step_terms", "StepCount",
           "local_param_bytes", "local_bytes"]

_UNSUPPORTED = ("group", "decode_attn_body")


def local_bytes(tree) -> int:
    """Bytes one device holds of a nest of tensors (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    if tree is None:
        return 0
    if isinstance(tree, torch.nn.Module):
        return local_bytes(list(tree.parameters()))
    if isinstance(tree, DTensor):
        t = tree.to_local()
        return t.numel() * t.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0


def local_param_bytes(params, mesh, cfg=None) -> float:
    """Per-device f32 gradient bytes of the parameters under the rules (the
    model axis divides what it shards; the data axes replicate)."""
    model = axis_sizes(mesh).get("model", 1)
    total = 0.0
    for name, spec in param_specs(params, mesh, cfg).items():
        n = float(params.get_parameter(name).numel())
        for entry in spec:
            axes = entry if isinstance(entry, tuple) else (entry,)
            if "model" in axes:
                n /= model
        total += n * 4.0
    return total


def _cast_params(params, dtype):
    """Floating parameters re-typed on meta (serving streams them in ``dtype``)."""
    with torch.no_grad():
        for p in params.parameters():
            if p.dtype.is_floating_point:
                p.data = torch.empty_like(p.data, dtype=dtype)
    return params


def _decode_cache(api, cfg: ModelConfig, shape: ShapeConfig, overrides):
    b, smax = shape.global_batch, shape.seq_len
    kv_dtype = overrides.get("kv_dtype", cfg.act_dtype)
    cache = api.init_cache(b, smax, dtype=kv_dtype)
    cache_len = overrides.get("cache_len")
    if cache_len is None or not isinstance(cache, list):
        return cache
    shp = (b, None, cfg.num_kv_heads, cfg.head_dim)
    for c, w in zip(cache, cfg.layer_pattern):
        if w != MAMBA:
            n = cache_len(w)
            c["k"] = torch.empty(shp[:1] + (n,) + shp[2:], dtype=kv_dtype, device=S.META)
            c["v"] = torch.empty_like(c["k"])
    return cache


class StepCount(NamedTuple):
    """One counted step: rank 0's counts, what the step took and gave (for
    ``memory_analysis``), and the seconds to lay it out and to run it."""
    counter: CostCounter
    chips: int
    model_flops: float
    args: Any
    outputs: Any
    extra: Dict[str, Any]
    setup_s: float
    run_s: float


def count_step(cfg: ModelConfig, shape: ShapeConfig, mesh, microbatches: int = 1,
               overrides: Optional[dict] = None) -> StepCount:
    """Counts one step of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh``)
    on meta tensors laid out by the rules: the one counting routine of the
    structured roofline and of ``launch.dryrun``."""
    from torch.distributed.tensor.experimental import implicit_replication

    overrides = dict(overrides or {})
    t0 = time.time()
    sizes = axis_sizes(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    train = shape.kind == "train"
    api = build_model(cfg, device="meta", remat=train)
    params = S.params_specs(api)
    if shape.kind == "decode":
        _cast_params(params, overrides.get("param_dtype", cfg.act_dtype))
    ar_bytes = local_param_bytes(params, mesh, cfg)
    distribute_params(params, mesh, cfg)
    sp = overrides.get("sequence_parallel", shape.kind != "decode")
    set_sharding_context(mesh, sequence_parallel=sp)
    counter = CostCounter()
    extra: Dict[str, Any] = {}
    try:
        with implicit_replication():
            if train:
                batch = S.batch_specs(cfg, shape)
                batch = distribute_tree(batch, batch_specs(batch, mesh), mesh)
                state = S.train_state_specs(params)
                args = (state, batch)
                mb = _split(batch, microbatches)[0] if microbatches > 1 else batch
                setup_s = time.time() - t0
                one = CostCounter()
                with one:
                    loss = api.loss_fn(params, mb)
                    loss.backward()
                counter.add(one, microbatches)
                reduce = CostCounter()
                with reduce:
                    grads = {k: p.grad.redistribute(p.device_mesh, p.placements)
                             for k, p in params.named_parameters()}
                extra["grad_reduce_bytes"] = float(sum(reduce.collectives.values()))
                with counter, torch.no_grad():
                    new_params, opt, metrics = adamw_update(AdamWConfig(), grads, state.opt,
                                                            params)
                outputs = (new_params, opt, dict(metrics, loss=loss.detach()))
                # the one true gradient DP all-reduce (none on one data-parallel
                # device); grad_ar_scale models wire-format compression
                # (12-bit fixed point: 15/32)
                if chips // sizes.get("model", 1) > 1:
                    counter.collectives["all-reduce"] += (
                        ar_bytes * overrides.get("grad_ar_scale", 1.0))
                mflops = model_flops_train(cfg, shape.global_batch * shape.seq_len)
            elif shape.kind == "prefill":
                batch = S.batch_specs(cfg, shape)
                batch = distribute_tree(batch, batch_specs(batch, mesh), mesh)
                cache = S.cache_specs(api, shape.global_batch, shape.seq_len)
                cache = distribute_tree(cache, cache_specs(cache, mesh, shape.global_batch),
                                        mesh)
                args = (params, batch, cache)
                setup_s = time.time() - t0
                with counter:
                    outputs = api.prefill(params, batch, cache)
                mflops = model_flops_forward(cfg, shape.global_batch * shape.seq_len)
            else:
                token, pos, _ = S.decode_specs(cfg, shape, api)
                cache = _decode_cache(api, cfg, shape, overrides)
                cache = distribute_tree(cache, cache_specs(cache, mesh, shape.global_batch),
                                        mesh)
                dp_ok = shape.global_batch % max(1, chips // sizes.get("model", 1)) == 0
                token = distribute_tree(token, batch_specs(token, mesh, dp_ok), mesh)
                args = (params, token, pos, cache)
                setup_s = time.time() - t0
                with counter:
                    outputs = api.decode_step(params, token, pos, cache)
                mflops = model_flops_forward(cfg, shape.global_batch)
    finally:
        set_sharding_context(None)
    return StepCount(counter, chips, mflops, args, outputs, extra, setup_s,
                     time.time() - t0 - setup_s)


def step_terms(sc: StepCount) -> Dict[str, Any]:
    """The roofline terms of a counted step, with the FLOPs by type and the
    compute term they give at each type's peak."""
    c = sc.counter
    return {**roofline(c.cost(), c.collectives, sc.chips, model_flops=sc.model_flops).as_dict(),
            "flops_by_dtype": dict(c.flops_by_dtype), "compute_s_by_dtype": c.compute_s(),
            **sc.extra}


def structured_roofline(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    microbatches: int = 1,
    decode_layer_fn=None,
    overrides: Optional[dict] = None,
) -> Dict[str, Any]:
    """Per-device FLOPs, bytes and collective bytes of one step of ``cfg`` at
    ``shape`` on ``mesh`` (a ``DeviceMesh``), and the three roofline terms."""
    bad = [k for k in _UNSUPPORTED if k in (overrides or {})]
    if decode_layer_fn is not None or bad:
        raise NotImplementedError(
            f"component builders {bad or ['decode_layer_fn']} have no counterpart: "
            f"the port counts the whole step, not per-component lowerings")
    return step_terms(count_step(cfg, shape, mesh, microbatches, overrides))
