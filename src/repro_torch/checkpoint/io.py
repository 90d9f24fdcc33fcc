"""Checkpoints in the reference's on-disk format: npz per step + manifest.

``directory/step_%08d/leaves.npz`` holds every leaf under its path (dict
keys in sorted order, list and tuple indices: ``weight_bits/0``,
``weight_bits/1``, ...), ``manifest.json`` its step, shapes, dtypes and the
caller's ``extra``.  Writes are atomic (a ``.tmp`` directory, then a rename).
The JAX package's ``repro.checkpoint.io`` writes and reads the same files,
so each package restores the other's checkpoints.

Leaves are torch tensors or numpy arrays; :func:`restore` gives each leaf
the dtype (and, for tensors, the device) of the matching leaf of
``tree_like``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _unflatten(tree_like, leaves: dict[str, Any], prefix: str = ""):
    def path(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, path(k)) for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, leaves, path(i)) for i, v in enumerate(tree_like))
    return leaves[prefix]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dirs(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save(tree, directory: str, step: int, *,
         extra: Optional[dict] = None) -> None:
    """Write checkpoint ``directory/step_<N>``."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "leaves.npz"), **flat)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def latest_step(directory: str) -> Optional[int]:
    steps = _step_dirs(directory)
    return steps[-1] if steps else None


def restore(tree_like, directory: str, step: int):
    """Restore into the structure of ``tree_like``; returns (tree, manifest)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = _flatten(tree_like)
    leaves = {}
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for k, t in like.items():
            arr = data[k]
            if isinstance(t, torch.Tensor):
                leaves[k] = torch.from_numpy(np.array(arr)).to(
                    device=t.device, dtype=t.dtype)
            else:
                leaves[k] = np.asarray(arr, dtype=np.asarray(t).dtype)
    return _unflatten(tree_like, leaves), manifest


def prune_old(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` steps."""
    for s in _step_dirs(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
