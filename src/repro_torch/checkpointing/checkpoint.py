"""Flat .npz checkpoints with a JSON tree manifest.

Port of `repro.checkpointing.checkpoint` on torch and numpy, writing the
same files: one ``<base>.npz`` whose entries are the tree's leaves under
``/``-joined paths (dict keys in sorted order, list and tuple indices,
None leaves absent — the paths of `jax.tree_util`), and a
``<base>.json`` manifest with ``step``, ``keys``, ``dtypes`` (numpy's
names) and ``extra``.  A checkpoint either package wrote loads in the
other.

bfloat16 leaves are stored as their raw 16-bit patterns (numpy's npz has
no bfloat16), through `Tensor.view`: no `ml_dtypes` is needed on either
side of a round trip.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint does not match the structure it is being restored into."""


def _base(path: str) -> str:
    # suffix-strip only: a ".npz" occurring mid-path (e.g. "runs.npz.d/ck")
    # must survive untouched
    return path[:-len(".npz")] if path.endswith(".npz") else path


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in `jax.tree_util` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """(array as written to the npz, its manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree, step: int = 0,
                    extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    dtypes: Dict[str, str] = {}
    stored: Dict[str, np.ndarray] = {}
    for key, leaf in _paths(tree):
        stored[key], dtypes[key] = _stored(leaf)
    base = _base(path)
    np.savez(base + ".npz", **stored)
    manifest = {"step": step, "keys": sorted(stored), "dtypes": dtypes,
                "extra": extra or {}}
    with open(base + ".json", "w") as f:
        json.dump(manifest, f)


def read_manifest(path: str) -> Dict[str, Any]:
    """The JSON manifest saved next to the .npz (step / keys / dtypes /
    extra) — readable without materializing any arrays, which is how
    `sim.SimService` recovers the spec a checkpoint was saved under
    before it can build the template tree `load_checkpoint` needs."""
    base = _base(path)
    try:
        with open(base + ".json") as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"no checkpoint manifest at {base + '.json'!r}")


def _restored(arr: np.ndarray, dtype_name, like, key: str):
    """One stored array as the kind of leaf the template holds: a torch
    leaf comes back as a tensor of its dtype on its device, anything
    else as a numpy array of the template's dtype."""
    if isinstance(like, torch.Tensor):
        shape = tuple(like.shape)
        if dtype_name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
    else:
        like = np.asarray(like)
        shape = like.shape
    if arr.shape != shape:
        raise CheckpointError(
            f"checkpoint leaf {key!r} has shape {arr.shape} but the "
            f"template expects {shape} — the checkpoint was saved from a "
            "differently-shaped run")
    if isinstance(like, torch.Tensor):
        return t.to(like.device, like.dtype)
    if dtype_name == "bfloat16":
        return arr.view(like.dtype)
    return np.asarray(arr, dtype=like.dtype)


def load_checkpoint(path: str, like_tree) -> Tuple[Any, int]:
    """Restores into the structure of ``like_tree``; returns (tree, step).

    Leaves come back as the same kind of array as the template: tensors
    for tensor leaves (the template's dtype and device), numpy arrays of
    the template's dtype for everything else (so float64/int64 survive).
    """
    base = _base(path)
    with np.load(base + ".npz") as data:
        with open(base + ".json") as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})

        def build(t, prefix):
            if t is None:
                return None
            if isinstance(t, dict):
                return {k: build(t[k], prefix + (str(k),))
                        for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                out = [build(v, prefix + (str(i),))
                       for i, v in enumerate(t)]
                return out if isinstance(t, list) else type(t)(out)
            key = "/".join(prefix)
            if key not in data:
                raise CheckpointError(
                    f"checkpoint {base!r} has no entry for leaf {key!r} "
                    f"(stored keys: {manifest.get('keys', [])})")
            return _restored(data[key], dtypes.get(key), t, key)

        tree = build(like_tree, ())
    return tree, manifest["step"]
