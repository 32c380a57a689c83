"""Atomic, async checkpointing (counterpart of ``repro.training.checkpoint``).

- **Layout**: ``step_XXXXXXXX/arrays.npz`` holds every tensor of the tree as
  a full array keyed by its path (``params/layers.0.attn.wq``,
  ``opt/step``, ``opt/mu/embed``, …) and ``meta.json`` the step and the
  keys.
- **Atomic**: writes go to ``step_XXXXXXXX.tmp`` and are renamed into place,
  so a crash mid-save never corrupts the latest checkpoint.
- **Async**: ``save_async`` copies every tensor to the host *before* it
  starts the writer thread, so the in-place optimizer of the next step
  cannot race with the write; the train loop blocks only for that copy.
- **Keep-k GC** and ``latest_step`` discovery for automatic restart.

A tree is a tensor, an ``nn.Module`` (its ``named_parameters``), a
NamedTuple, a dict or a list of trees, or ``None`` (no entry).
``restore(..., device=)`` places the tensors on a device;
``restore(..., shardings=)`` lays each one out on a ``DeviceMesh`` instead:
the elastic-rescale path, the stored full arrays re-sharded onto the
*current* mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["save", "save_async", "wait_pending", "latest_step", "restore"]


def _items(tree):
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    return list(enumerate(tree))


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for key, val in _items(tree):
        out.update(_flatten_with_paths(val, f"{prefix}/{key}" if prefix else str(key)))
    return out


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: v.detach().cpu().numpy() for k, v in _flatten_with_paths(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


_PENDING: list = []


def save_async(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> threading.Thread:
    """Device→host copy now; the disk write on a daemon thread."""
    host = {k: v.detach().to("cpu", copy=True)
            for k, v in _flatten_with_paths(tree).items()}
    t = threading.Thread(target=save, args=(ckpt_dir, step, host, keep), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def _steps(ckpt_dir: str):
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, device=None, shardings: Any = None) -> Any:
    """Restore into the structure of ``like``: each tensor takes its stored
    values in ``like``'s dtype, on ``device`` (default: ``like``'s own).  A
    module's parameters keep their objects (``.data`` replaced); every other
    tensor is new.

    ``shardings`` (the elastic-rescale path) matches ``like``'s structure
    (a module's entry is a dict by parameter name) with ``(mesh,
    placements)`` pairs, or ``None`` where a tensor stays whole: each such
    tensor becomes a DTensor on ``mesh``, every rank taking its own slice of
    the stored array (all ranks read the same file, so nothing is sent), and
    a module's parameter is replaced by a parameter holding it."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}

    def load(key: str, leaf: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is not None:
            from torch.distributed.tensor import distribute_tensor

            mesh, placements = shard
            dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
                if mesh.device_type == "cuda" else torch.device(mesh.device_type)
            full = torch.from_numpy(arrays[key]).to(device=dev, dtype=leaf.dtype)
            return distribute_tensor(full, mesh, placements, src_data_rank=None)
        return torch.from_numpy(arrays[key]).to(
            device=leaf.device if device is None else device, dtype=leaf.dtype)

    def sub(shard, key):
        """``shardings``' entry under ``key`` (a dict's key, a NamedTuple's
        field, a list's index)."""
        if shard is None:
            return None
        if isinstance(shard, dict):
            return shard.get(key)
        return getattr(shard, key) if isinstance(key, str) else shard[key]

    def rebuild(tree, prefix: str = "", shard=None):
        if tree is None:
            return None
        if isinstance(tree, torch.Tensor):
            return load(prefix, tree, shard)
        if isinstance(tree, nn.Module):
            with torch.no_grad():
                for name, p in list(tree.named_parameters()):
                    key = f"{prefix}/{name}" if prefix else name
                    s = sub(shard, name)
                    if s is None:
                        p.data = load(key, p)
                        continue
                    owner, _, leaf = name.rpartition(".")
                    setattr(tree.get_submodule(owner), leaf,
                            nn.Parameter(load(key, p, s), requires_grad=p.requires_grad))
            return tree
        vals = [(k, rebuild(v, f"{prefix}/{k}" if prefix else str(k), sub(shard, k)))
                for k, v in _items(tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(v for _, v in vals))
        if isinstance(tree, dict):
            return dict(vals)
        return type(tree)(v for _, v in vals)

    return rebuild(like, shard=shardings)


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
