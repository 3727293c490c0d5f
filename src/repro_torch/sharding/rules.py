"""Partition rules: FSDP over ("pod", "data"), tensor/expert over "model".

Port of `repro.sharding.rules`.  A spec is plain data, as the
reference's `PartitionSpec`: a tuple with one entry per tensor dim, each
None (replicated), an axis name, or a tuple of axis names (the dim split
over those mesh axes, major to minor).  The rules are name-based over the
param tree's paths ("blocks/attn/wq/w") and read only the mesh's axis
sizes, so ``mesh`` is anything with a ``shape`` mapping axis -> size, or
a `torch.distributed.device_mesh.DeviceMesh` (`axis_sizes`).

Every rule respects divisibility: a dim is only sharded on axes whose
size divides it; otherwise the next candidate applies or the dim is
replicated.  Stacked block params carry a leading layer dim that is never
sharded.

`shardings_for` turns specs into DTensor placements on a DeviceMesh, one
placement per mesh dim; `place` distributes a tree by them.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

Spec = Tuple[object, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of anything whose ``shape``
    maps axis names to sizes (a JAX mesh, a dict holder)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fit(sizes: Dict[str, int], dim: int, axes) -> Optional[object]:
    """``axes`` if ``dim`` divides evenly over them, else None."""
    return axes if axes is not None and dim % _axis_size(sizes, axes) == 0 \
        else None


def _walk(tree, path=""):
    """(path, leaf) pairs of a nested-dict tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def _rebuild(tree, values, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, f"{path}/{k}" if path
                            else str(k)) for k in sorted(tree)}
    return values[path]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

def _leaf_spec(sizes: Dict[str, int], key: str, shape: Tuple[int, ...],
               fsdp, stacked: bool) -> Spec:
    """The spec of one parameter leaf."""
    lead = 1 if stacked else 0
    nd = len(shape) - lead
    dims = shape[lead:]

    def spec(*entries):
        return (None,) * lead + entries

    model = _fit(sizes, dims[-1] if nd else 1, "model")

    if nd == 0 or re.search(r"norm|bias|/b$|A_log|^D$|/D$|dt_bias|idx",
                            key):
        return spec(*(None,) * nd)

    if re.search(r"(embed|unembed)/w$", key):
        return spec(_fit(sizes, dims[0], "model"), _fit(sizes, dims[1], fsdp))

    if re.search(r"router/w$", key):
        return spec(_fit(sizes, dims[0], fsdp), None)

    if re.search(r"(w_gate|w_up)$", key) and nd == 3:   # experts (E, d, f)
        return spec(_fit(sizes, dims[0], "model"), _fit(sizes, dims[1], fsdp),
                    None)
    if re.search(r"w_down$", key) and nd == 3:          # experts (E, f, d)
        return spec(_fit(sizes, dims[0], "model"), None,
                    _fit(sizes, dims[2], fsdp))

    if re.search(r"(wq|wk|wv|w_gate|w_up|in_proj|x_proj|dt_proj)/w$",
                 key) and nd == 2:
        return spec(_fit(sizes, dims[0], fsdp), _fit(sizes, dims[1], "model"))
    if re.search(r"(wo|w_down|out_proj)/w$", key) and nd == 2:
        return spec(_fit(sizes, dims[0], "model"), _fit(sizes, dims[1], fsdp))
    if re.search(r"conv_w$", key):
        return spec(None, _fit(sizes, dims[1], "model"))
    if re.search(r"A_log|norm_scale", key):
        return spec(*(None,) * nd)
    if re.search(r"conv1|conv2|fc", key):               # paper CNN: replicate
        return spec(*(None,) * nd)

    # default: last dim on model, first on fsdp, when they divide
    if nd >= 2:
        return spec(_fit(sizes, dims[0], fsdp), *(None,) * (nd - 2), model)
    return spec(_fit(sizes, dims[0], "model"))


_STACKED_RE = re.compile(r"^(blocks|encoder/blocks)/")


def param_pspecs(mesh, params_shape, fsdp=("data",)):
    """A tree of specs matching a params (or params-shape) tree."""
    sizes = axis_sizes(mesh)
    return _rebuild(params_shape, {
        key: _leaf_spec(sizes, key, _shape(leaf), fsdp,
                        bool(_STACKED_RE.match(key)))
        for key, leaf in _walk(params_shape)})


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def _present(sizes: Dict[str, int], axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if a in sizes)


def batch_pspec(mesh, batch_shape, dp=("data",)):
    """Plain step: the leading batch dim over the data(+pod) axes."""
    sizes = axis_sizes(mesh)
    dp_axes = _present(sizes, dp)

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        if leaf.shape[0] % _axis_size(sizes, dp_axes) == 0:
            return (dp_axes,) + (None,) * (nd - 1)
        return (None,) * nd

    return _map(one, batch_shape)


def fed_batch_pspec(mesh, batch_shape, node_axes=("pod", "data")):
    """Fed step: the leading NODE dim over (pod, data)."""
    axes = _present(axis_sizes(mesh), node_axes)

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        return (axes,) + (None,) * (nd - 1)

    return _map(one, batch_shape)


def cache_pspecs(mesh, cache_shape, dp=("data",)):
    """KV/SSM caches: the batch dim over data(+pod); kv-heads on model
    when they divide, otherwise the cache length; ssm states shard
    d_inner (mamba2: heads) on model."""
    sizes = axis_sizes(mesh)
    dp_axes = _present(sizes, dp)
    n_dp = _axis_size(sizes, dp_axes)
    specs = {}
    for key, leaf in _walk(cache_shape):
        shp = _shape(leaf)
        nd = len(shp)
        if nd == 0 or key.endswith("idx") or key == "pos":
            specs[key] = (None,) * nd
            continue
        b = dp_axes if nd > 1 and shp[1] % n_dp == 0 else None
        if re.search(r"(kv|cross|attn)/(k|v)$", key):
            # (L, B, C, KV, hd)
            kv_m = _fit(sizes, shp[3], "model")
            c_m = _fit(sizes, shp[2], "model") if kv_m is None else None
            specs[key] = (None, b, c_m, kv_m, None)
        elif re.search(r"ssm/h$", key):
            # mamba1 (L, B, di, N) / mamba2 (L, B, H, P, N)
            specs[key] = (None, b, _fit(sizes, shp[2], "model")) \
                + (None,) * (nd - 3)
        elif re.search(r"ssm/conv$", key):
            # (L, B, K-1, conv_dim)
            specs[key] = (None, b, None, _fit(sizes, shp[3], "model"))
        else:
            specs[key] = (None,) * nd
    return _rebuild(cache_shape, specs)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def placements_for(mesh, spec: Spec):
    """The DTensor placements of one spec on a DeviceMesh: Shard(d) on
    every mesh dim named in entry d (an entry ("pod", "data") shards dim d
    on both, pod major), Replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shardings_for(mesh, pspecs):
    """A tree of specs -> the same tree of placement tuples."""
    if is_spec(pspecs):
        return placements_for(mesh, pspecs)
    if isinstance(pspecs, dict):
        return {k: shardings_for(mesh, v) for k, v in pspecs.items()}
    if isinstance(pspecs, (list, tuple)):
        return type(pspecs)(shardings_for(mesh, v) for v in pspecs)
    raise TypeError(f"not a spec tree: {pspecs!r}")


def _plain_leaf(path: str) -> bool:
    """The caches' token counters ("idx", "pos") stay plain tensors: every
    rank holds the same value and updates it on the host's schedule."""
    return path.rsplit("/", 1)[-1] in ("idx", "pos")


def place(mesh, tree, specs, make=None):
    """``tree`` (a tensor, a dict tree, or a tuple of them, as a step's
    args) distributed by ``specs`` (the same structure) onto ``mesh``:
    each tensor leaf a DTensor with `placements_for` its spec, except
    the caches' counters; non-tensors pass.  ``make(leaf, placements)``
    builds each DTensor (default: `distribute_tensor`, whose source is
    rank 0's tensor)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    if make is None:
        def make(x, pl):
            return distribute_tensor(x, mesh, pl)

    def one(x, spec, path):
        if isinstance(x, dict):
            return {k: one(x[k], spec[k], f"{path}/{k}" if path else k)
                    for k in x}
        if isinstance(x, (tuple, list)):
            return type(x)(one(a, s, path) for a, s in zip(x, spec))
        if not isinstance(x, torch.Tensor) or _plain_leaf(path):
            return x
        if x.ndim and not spec:        # () on a tensor: replicated
            spec = (None,) * x.ndim
        return make(x, placements_for(mesh, spec))

    return one(tree, specs, "")
