"""Carry state between the reference package and the port as numpy arrays.

The port never imports the reference.  Tests and tools that hold both hand
graphs, raw fixed-point states and LM parameters across with these, so that
both packages compute on the same bits.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coo import COOGraph
from repro_torch.models.common import find_segments
from repro_torch.models.transformer import Transformer

__all__ = ["graph_from_arrays", "raw_to_torch", "raw_to_numpy", "lm_params_from_jax",
           "lm_name_map", "leaf_at"]


def graph_from_arrays(x, y, val, dangling, num_vertices: int) -> COOGraph:
    """A port ``COOGraph`` from a reference graph's arrays (copied as they are:
    x/y int32, val float32, dangling bool)."""
    return COOGraph(num_vertices=int(num_vertices),
                    x=np.asarray(x, np.int32).copy(),
                    y=np.asarray(y, np.int32).copy(),
                    val=np.asarray(val, np.float32).copy(),
                    dangling=np.asarray(dangling, bool).copy())


def raw_to_torch(raw: np.ndarray, device="cpu") -> torch.Tensor:
    """np.uint32 raw Qm.f values → int32 tensor holding the same bits."""
    raw = np.ascontiguousarray(np.asarray(raw, np.uint32))
    return torch.from_numpy(raw.view(np.int32).copy()).to(device)


def raw_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of raw bits → np.uint32 array of the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def _leaves(tree: Dict[str, Any], prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def leaf_at(tree, path: Tuple) -> Any:
    """The leaf of a nested dict/list ``tree`` at ``path`` (keys and indices)."""
    for key in path:
        tree = tree[key]
    return tree


def lm_name_map(params_np: Dict[str, Any], cfg: ModelConfig
                ) -> Dict[str, Tuple[Tuple, Tuple[int, ...]]]:
    """The port's parameter name → (the reference's leaf path, index into
    that leaf), for every parameter of every family.

    The reference stacks each pattern segment's layers as
    ``params["segments"][s][key][rep, j]`` (expert tensors ``[E, D, F]``
    behind the two stack axes; mamba layers as ``segments[0]`` of group
    ``(MAMBA,)``); layer ``i`` of the port is the ``i``-th (segment, rep, j)
    in order.  whisper's ``encoder`` is stacked ``[L, …]``: the port's
    ``encoder.i``.  Every other entry (``embed``, ``final_norm``,
    ``unembed``, ``pos_embed``, zamba2's ``shared_attn``, ``enc_pos``,
    ``enc_final_norm``, ``patch_proj``) keeps its name.  The same map reads
    a gradient or optimizer-moment tree of the reference leaf by leaf."""
    names: Dict[str, Tuple[Tuple, Tuple[int, ...]]] = {}
    for path, _ in _leaves({k: v for k, v in params_np.items()
                            if k not in ("segments", "encoder")}):
        names[".".join(path)] = (path, ())
    for path, leaf in _leaves(params_np.get("encoder", {})):
        for i in range(np.shape(leaf)[0]):
            names[f"encoder.{i}." + ".".join(path)] = (("encoder",) + path, (i,))
    i = 0
    for s, (seg, (group, reps)) in enumerate(zip(params_np["segments"],
                                                 find_segments(cfg.layer_pattern))):
        for rep in range(reps):
            for j in range(len(group)):
                for path, _ in _leaves(seg):
                    names[f"layers.{i}." + ".".join(path)] = (("segments", s) + path, (rep, j))
                i += 1
    return names


def lm_params_from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
                       trainable: bool = False) -> Transformer:
    """The port's ``Transformer``, on the CPU, from the reference's parameter
    pytree (leaves as numpy arrays), laid out by ``lm_name_map``.  Raises on
    any missing or extra key.  The parameters are frozen unless
    ``trainable``."""
    state = {name: np.asarray(leaf_at(params_np, path))[index]
             for name, (path, index) in lm_name_map(params_np, cfg).items()}
    model = Transformer(cfg, device="meta")
    model.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                           for k, v in state.items()}, strict=True, assign=True)
    return model.requires_grad_(trainable)
