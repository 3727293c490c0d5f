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

Node keys are ``prng.split(key, N)``, as `jax.random.split`.  Training
runs under `device.deterministic`: autograd's scatter-adds (the
embedding's and the loss gather's backward) take PyTorch's deterministic
algorithms on the card, so a round repeats bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from ..device import deterministic
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
        p.sub_(g * torch.tensor(lr, dtype=p.dtype, device=p.device))


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
                   fcfg: FedStepConfig) -> Tuple[object, dict]:
    """One federated round.

    Args:
      global_params: the global model ω_t (a tree of tensors).
      node_batches: tree, leaves (n_nodes, local_steps, per_node_batch, ...).
      eval_batch: the cloud's testing batch for Alg. 2; ignored when
        fcfg.detect is False or acc_fn is None.
      key: uint32 (2,) key; split into one key per node for the noise.
      loss_fn: (params, batch) -> (loss, aux_metrics).
      acc_fn: (params, eval_batch) -> scalar accuracy in [0, 1].

    Returns (ω_{t+1}, metrics), the reference's metrics.
    """
    N = fcfg.n_nodes
    node_keys = prng.split(np.asarray(key, np.uint32), N)
    deltas, node_losses, norms = [], [], []
    for n in range(N):
        # --- 1. local training (no cross-node work) ---------------------
        local, loss = _local_sgd(
            loss_fn, fcfg.local_steps, fcfg.lr, global_params,
            tree_util.map(lambda b: b[n], node_batches))
        node_losses.append(loss)
        # --- 2. ALDP: clip + Gaussian noise under the node's key --------
        with torch.no_grad():
            delta = tree_util.map(lambda p, g: p - g.to(p.dtype), local,
                                  global_params)
            del local
            delta, nrm = aldp.clip_by_global_norm(delta, fcfg.clip_s)
            if fcfg.sigma > 0:
                delta = aldp.add_gaussian_noise(delta, node_keys[n],
                                                fcfg.sigma, fcfg.clip_s)
        deltas.append(delta)
        norms.append(nrm)
    node_losses = torch.stack(node_losses)
    dev = node_losses.device

    with torch.no_grad():
        # --- 3. cloud-side malicious-node detection (Alg. 2) ------------
        if fcfg.detect and acc_fn is not None:
            accs = torch.stack([
                acc_fn(tree_util.map(lambda g, d: g.to(d.dtype) + d,
                                     global_params, d), eval_batch)
                .to(torch.float32) for d in deltas])
            mask, thr = detection.detect(accs, fcfg.detect_s)
        else:
            accs = torch.zeros((N,), dtype=torch.float32, device=dev)
            mask = torch.ones((N,), dtype=torch.bool, device=dev)
            thr = torch.zeros((), dtype=torch.float32, device=dev)

        # --- 4. masked mean over nodes + α-mix (Eq. 6), leaf by leaf ----
        node_leaves = [tree_util.leaves(d) for d in deltas]
        del deltas
        new = []
        for i, g in enumerate(tree_util.leaves(global_params)):
            stacked = torch.stack([leaves[i] for leaves in node_leaves])
            for leaves in node_leaves:
                leaves[i] = None
            mean = detection.masked_mean(stacked, mask)
            del stacked
            new.append((g.to(torch.float32) + mean * np.float32(
                1.0 - fcfg.alpha)).to(g.dtype))
        new_params = tree_util.unflatten_like(global_params, new)

    metrics = {
        "loss": mean_compiled(node_losses),
        "node_losses": node_losses,
        "delta_norm_mean": mean_compiled(torch.stack(norms)),
        "node_accuracies": accs,
        "detect_threshold": thr,
        "n_normal": mask.sum(),
    }
    return new_params, metrics


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
