"""The paper's round mapped onto a transformer: `fed_train_step`.

Port of `repro.core.fed_step`.  One federated round:

  1. each node runs `local_steps` of node-local SGD from the global
     params (autograd; the reference vmaps a `lax.scan`, which emits no
     cross-node work, so the nodes run here one after another and one
     node's grads are alive at a time);
  2. each node's delta is clipped at S and perturbed with N(0, σ²S²)
     under the node's key (ALDP, Eq. 8: `aldp.clip_by_global_norm`, then
     `aldp.add_gaussian_noise`, leaf by leaf);
  3. the cloud tests every node model g + d on a held-out batch and keeps
     the top-s% (malicious-node detection, Alg. 2);
  4. the masked mean over nodes and the α-mix server update (Eq. 6).

`plain_train_step` is the SFL baseline (one synchronous step).

On a device mesh (``spmd_axes``: the data-parallel axes, params as
DTensors placed by `sharding.rules`), the round runs as the reference's
``vmap(spmd_axis_name=...)`` splits it: the nodes are split over the dp
axes as `fed_batch_pspec` splits ``node_batches``; each dp rank trains
its own nodes, one after another, on the params gathered over the FSDP
axes and still sharded on "model" (a DTensor on the "model" sub-mesh);
clip and noise act on that rank's shards (the norm is an all-reduce,
the noise drawn at each element's global counter, so the draws are the
unsharded ones bit for bit); Alg. 2 reads every node's accuracy,
all-gathered over the dp axes; the masked mean is one all-reduce of
each rank's partial sums, and the α-mix lands in the params' placement.
A rank holds its own nodes' deltas, never all N.

Node keys are ``prng.split(key, N)``, as `jax.random.split`.  Training
runs under `device.deterministic`: autograd's scatter-adds (the
embedding's and the loss gather's backward) take PyTorch's deterministic
algorithms on the card, so a round repeats bit for bit.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from ..device import deterministic
from ..sharding import ctx
from . import aldp, detection
from .numerics import mean_compiled


@dataclass(frozen=True)
class FedStepConfig:
    n_nodes: int = 16
    local_steps: int = 4
    lr: float = 1e-2
    alpha: float = 0.5         # Eq. (6)
    clip_s: float = 1.0
    sigma: float = 1e-3        # noise multiplier (0 disables ALDP)
    detect: bool = True
    detect_s: float = 80.0


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, aux, grads) of ``loss_fn(params, batch) -> (loss, aux)``
    with respect to ``params``, under `device.deterministic`; a leaf the
    loss does not reach gets a zero grad, as `jax.grad` gives it."""
    leaves = [p.detach().requires_grad_(True)
              for p in tree_util.leaves(params)]
    with torch.enable_grad(), deterministic():
        loss, aux = loss_fn(tree_util.unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g   # unused: zero, as jax
             for p, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_util.unflatten_like(params, grads)


def _sgd_(params, grads, lr: float) -> None:
    """p ← p − lr·g in place, rounded as the reference's
    ``(a − lr·g.astype(a.dtype)).astype(a.dtype)`` (lr in a's dtype)."""
    for p, g in zip(tree_util.leaves(params), tree_util.leaves(grads)):
        g = g.to(p.dtype)
        p.sub_(g * ctx.like(torch.tensor(lr, dtype=p.dtype,
                                         device=p.device), g))


def _local_sgd(loss_fn: Callable, steps: int, lr: float, params, batches):
    """``batches``: tree with leading (steps, ...) axis.  Returns (params,
    mean loss).  ``params`` are copied, never written."""
    params = tree_util.map(lambda p: p.detach().clone(), params)
    losses = []
    for s in range(steps):
        loss, _, grads = value_and_grad(
            loss_fn, params, tree_util.map(lambda b: b[s], batches))
        with torch.no_grad():
            _sgd_(params, grads, lr)
        losses.append(loss.to(torch.float32))
        del grads
    return params, mean_compiled(torch.stack(losses))


def fed_train_step(global_params, node_batches, eval_batch, key, *,
                   loss_fn: Callable, acc_fn: Optional[Callable],
                   fcfg: FedStepConfig, spmd_axes=None
                   ) -> Tuple[object, dict]:
    """One federated round.

    Args:
      global_params: the global model ω_t (a tree of tensors).
      node_batches: tree, leaves (n_nodes, local_steps, per_node_batch, ...).
      eval_batch: the cloud's testing batch for Alg. 2; ignored when
        fcfg.detect is False or acc_fn is None.
      key: uint32 (2,) key; split into one key per node for the noise.
      loss_fn: (params, batch) -> (loss, aux_metrics).
      acc_fn: (params, eval_batch) -> scalar accuracy in [0, 1].

      spmd_axes: the mesh's data-parallel axes, when the params are
        DTensors on a device mesh (the sharded round, above).  Off a
        mesh one rank owns every node and the gathers are the local
        values.

    Returns (ω_{t+1}, metrics), the reference's metrics.
    """
    mesh, names, dp = None, (), ()
    if spmd_axes is not None and ctx.is_dtensor(
            tree_util.leaves(global_params)[0]):
        mesh = tree_util.leaves(global_params)[0].device_mesh
        names = tuple(mesh.mesh_dim_names)
        dp = tuple(a for a in spmd_axes if a in names)
    r, n_dp, sub = _mesh_layout(mesh, dp)
    N = fcfg.n_nodes
    if N % n_dp:
        raise ValueError(f"{N} nodes do not split over the dp axes {dp} "
                         f"({n_dp} ranks)")
    per = N // n_dp
    node_keys = prng.split(np.asarray(key, np.uint32), N)
    # this rank's nodes' batches (the node dim is sharded over dp)
    mine = tree_util.map(
        lambda b: b.to_local() if ctx.is_dtensor(b) else
        b[r * per:(r + 1) * per], node_batches)
    g_model, evalb = global_params, eval_batch
    if mesh is not None:
        g_model = tree_util.map(lambda p: _on_model_mesh(p, sub),
                                global_params)
        evalb = tree_util.map(lambda b: _on_model_mesh(
            b.full_tensor() if ctx.is_dtensor(b) else b, sub), eval_batch)
    detect = fcfg.detect and acc_fn is not None
    deltas, node_losses, norms, accs = [], [], [], []
    sub_ctx = ctx.mesh_context(sub, ()) if sub is not None \
        else contextlib.nullcontext()
    with sub_ctx, ctx.suspended():
        for j in range(per):
            # --- 1. local training (no cross-node work) -----------------
            batches = tree_util.map(lambda b: _on_model_mesh(b[j], sub),
                                    mine)
            local, loss = _local_sgd(loss_fn, fcfg.local_steps, fcfg.lr,
                                     g_model, batches)
            node_losses.append(_plain(loss))
            # --- 2. ALDP: clip + Gaussian noise under the node's key ----
            with torch.no_grad():
                delta = tree_util.map(lambda p, g: p - g.to(p.dtype), local,
                                      g_model)
                del local
                delta, nrm = aldp.clip_by_global_norm(delta, fcfg.clip_s)
                if fcfg.sigma > 0:
                    delta = aldp.add_gaussian_noise(
                        delta, node_keys[r * per + j], fcfg.sigma,
                        fcfg.clip_s)
                # the cloud tests the node model g + d (Alg. 2's input)
                if detect:
                    accs.append(_plain(acc_fn(tree_util.map(
                        lambda g, d: g.to(d.dtype) + d, g_model, delta),
                        evalb)).to(torch.float32))
            deltas.append(delta)
            norms.append(_plain(nrm))
    node_losses = _gather_nodes(torch.stack(node_losses), mesh, dp)
    norms = _gather_nodes(torch.stack(norms), mesh, dp)
    dev = node_losses.device

    with torch.no_grad():
        # --- 3. malicious-node detection (Alg. 2) on every node ---------
        if detect:
            accs = _gather_nodes(torch.stack(accs), mesh, dp)
            mask, thr = detection.detect(accs, fcfg.detect_s)
        else:
            accs = torch.zeros((N,), dtype=torch.float32, device=dev)
            mask = torch.ones((N,), dtype=torch.bool, device=dev)
            thr = torch.zeros((), dtype=torch.float32, device=dev)
        w = mask.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        mine_w = w[r * per:(r + 1) * per]

        # --- 4. masked mean over nodes + α-mix (Eq. 6), leaf by leaf:
        # this rank's partial sums as `detection.masked_mean` sums them,
        # then (on a mesh) one all-reduce over the dp axes
        node_leaves = [tree_util.leaves(d) for d in deltas]
        del deltas
        new = []
        for i, g in enumerate(tree_util.leaves(global_params)):
            stacked = torch.stack([
                x.to_local() if ctx.is_dtensor(x) else x
                for x in (leaves[i] for leaves in node_leaves)])
            for leaves in node_leaves:
                leaves[i] = None
            wf = mine_w.reshape((-1,) + (1,) * (stacked.ndim - 1))
            part = (stacked.to(torch.float32) * wf).sum(0)
            del stacked
            if mesh is None:
                mean = part / denom
            else:
                from torch.distributed.tensor import (DTensor, Partial,
                                                      Replicate)
                pl = [Partial() if n in dp else Replicate() for n in names]
                if sub is not None:
                    pl[names.index("model")] = \
                        g.placements[names.index("model")]
                total = DTensor.from_local(part, mesh, pl, run_check=False,
                                           shape=g.shape, stride=g.stride())
                mean = total.redistribute(mesh, g.placements) \
                    / ctx.like(denom, total)
            new.append((g.to(torch.float32) + mean * np.float32(
                1.0 - fcfg.alpha)).to(g.dtype))
        new_params = tree_util.unflatten_like(global_params, new)

    metrics = {
        "loss": mean_compiled(node_losses),
        "node_losses": node_losses,
        "delta_norm_mean": mean_compiled(norms),
        "node_accuracies": accs,
        "detect_threshold": thr,
        "n_normal": mask.sum(),
    }
    return new_params, metrics


# ---------------------------------------------------------------------------
# The round on a device mesh: which nodes a rank owns, and the gathers
# ---------------------------------------------------------------------------

def _mesh_layout(mesh, dp: Tuple[str, ...]):
    """(this rank's index along the dp axes, major to minor; their total
    size; the "model" sub-mesh or None); (0, 1, None) off a mesh."""
    if mesh is None:
        return 0, 1, None
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx, n_dp = 0, 1
    for a in dp:
        size = mesh.size(names.index(a))
        idx = idx * size + coord[names.index(a)]
        n_dp *= size
    sub = mesh["model"] if "model" in names else None
    return idx, n_dp, sub


def _on_model_mesh(x, sub):
    """A global-mesh DTensor gathered over every axis but "model", as a
    DTensor on the "model" sub-mesh (a plain tensor when the mesh has
    no "model" axis); a plain tensor, replicated on ``sub`` (as it is
    when ``sub`` is None)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not ctx.is_dtensor(x):
        if sub is None:
            return x
        return DTensor.from_local(x, sub, [Replicate()], run_check=False)
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if sub is None:
        return x.full_tensor()
    m = names.index("model")
    keep = x.placements[m]
    g = x.redistribute(mesh, [keep if i == m else Replicate()
                              for i in range(len(names))])
    return DTensor.from_local(g.to_local(), sub, [keep], run_check=False)


def _gather_nodes(local: torch.Tensor, mesh, dp) -> torch.Tensor:
    """(per, ...) per-rank rows -> (N, ...) in node order on every rank
    (``local`` itself off a mesh)."""
    if mesh is None:
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    pl = [Shard(0) if n in dp else Replicate() for n in names]
    return DTensor.from_local(local, mesh, pl, run_check=False).full_tensor()


def _plain(x: torch.Tensor) -> torch.Tensor:
    """A replicated scalar's value as a plain tensor."""
    return x.full_tensor() if ctx.is_dtensor(x) else x


# ---------------------------------------------------------------------------
# SFL baseline: one synchronous step
# ---------------------------------------------------------------------------

def plain_train_step(params, opt_state, batch, *, loss_fn: Callable,
                     optimizer) -> Tuple[object, object, dict]:
    """One synchronous step: the grads of the whole batch, then one
    optimizer update (the paper's SFL)."""
    loss, aux, grads = value_and_grad(loss_fn, params, batch)
    with torch.no_grad():
        params, opt_state = optimizer.update(params, grads, opt_state)
    metrics = {"loss": loss}
    if isinstance(aux, dict):
        metrics.update({k: v.detach() for k, v in aux.items()
                        if torch.is_tensor(v) and v.ndim == 0})
    return params, opt_state, metrics
