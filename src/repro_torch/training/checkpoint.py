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
``restore(..., device=)`` places the tensors on a device; a re-shard onto a
mesh waits for the port's ``distributed/``.
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


def restore(ckpt_dir: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like``: each tensor takes its stored
    values in ``like``'s dtype, on ``device`` (default: ``like``'s own).  A
    module's parameters keep their objects (``.data`` replaced); every other
    tensor is new."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}

    def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(arrays[key]).to(
            device=leaf.device if device is None else device, dtype=leaf.dtype)

    def rebuild(tree, prefix: str = ""):
        if tree is None:
            return None
        if isinstance(tree, torch.Tensor):
            return load(prefix, tree)
        if isinstance(tree, nn.Module):
            with torch.no_grad():
                for name, p in tree.named_parameters():
                    p.data = load(f"{prefix}/{name}" if prefix else name, p)
            return tree
        vals = [(k, rebuild(v, f"{prefix}/{k}" if prefix else str(k)))
                for k, v in _items(tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(v for _, v in vals))
        if isinstance(tree, dict):
            return dict(vals)
        return type(tree)(v for _, v in vals)

    return rebuild(like)


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
