"""The attacks the framework defends against — paper §3.3 + the zoo.

Port of `repro.core.attacks`: the data-level poisoning (`flip_labels`,
`stamp_trigger`: numpy, applied to the host-side shards before any
tensor exists), the attacker's objectives on held-out data
(`flip_success_rate`, `backdoor_success_rate`) and gradient leakage (DLG,
Zhu et al. 2019: reconstruct a node's batch from its uploaded gradients
by gradient matching, Eq. 4) with its metrics.  The engine-side attacks
(sybil, adaptive, ddos) live in `fleet.stages`.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from .async_update import powf


def flip_labels(labels: np.ndarray, src: int, dst: int) -> np.ndarray:
    """Change every label `src` to `dst` (the paper's attack)."""
    labels = np.asarray(labels)
    return np.where(labels == src, dst, labels).astype(labels.dtype)


def stamp_trigger(x: np.ndarray, size: int = 2,
                  value: float = 1.0) -> np.ndarray:
    """Stamp a ``size``×``size`` patch of ``value`` into the top-left
    corner of every image in ``x`` ((..., H, W, C)); returns a copy."""
    out = np.array(x, copy=True)
    out[..., :size, :size, :] = value
    return out


def _device(params) -> torch.device:
    return tree_util.leaves(params)[0].device


def _predict(forward: Callable, params, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        logits = forward(params, torch.as_tensor(np.asarray(x),
                                                 device=_device(params)))
    return torch.argmax(logits, -1).cpu().numpy()


def flip_success_rate(forward: Callable, params, x: np.ndarray,
                      y: np.ndarray, src: int, dst: int) -> float:
    """Label-flip attacker objective on held-out data: the fraction of
    true-``src`` samples the model now assigns to ``dst``."""
    sel = np.asarray(y) == src
    if not sel.any():
        return 0.0
    pred = _predict(forward, params, np.asarray(x)[np.where(sel)[0]])
    return float((pred == dst).mean())


def backdoor_success_rate(forward: Callable, params, x: np.ndarray,
                          y: np.ndarray, trigger_label: int,
                          trigger_size: int = 2,
                          trigger_value: float = 1.0) -> float:
    """Backdoor attacker objective: the fraction of non-target-class
    held-out samples that flip to ``trigger_label`` once stamped."""
    sel = np.asarray(y) != trigger_label
    if not sel.any():
        return 0.0
    xt = stamp_trigger(np.asarray(x)[sel], size=trigger_size,
                       value=trigger_value)
    pred = _predict(forward, params, xt)
    return float((pred == trigger_label).mean())


def _grad_match_loss(loss_fn: Callable, params, dummy_x, dummy_logits_y,
                     true_grads) -> torch.Tensor:
    """‖∇L(F(W, X'); Y') − g‖² with soft labels (DLG uses softmax(Y')),
    differentiable in (X', Y'): the gradient keeps its graph."""
    y_soft = torch.softmax(dummy_logits_y, -1)
    leaves = [p.detach().requires_grad_(True)
              for p in tree_util.leaves(params)]
    loss = loss_fn(tree_util.unflatten_like(params, leaves), dummy_x, y_soft)
    g = torch.autograd.grad(loss, leaves, create_graph=True)
    return sum(torch.sum(torch.square(a.to(torch.float32)
                                      - b.to(torch.float32)))
               for a, b in zip(g, tree_util.leaves(true_grads)))


def dlg_attack(loss_fn: Callable, params, true_grads, x_shape,
               n_classes: int, key, steps: int = 200, lr: float = 0.1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run DLG: Adam on (X', Y') against the gradient-match objective.

    loss_fn(params, x, y_soft) -> scalar; ``key`` a uint32 (2,) key whose
    two halves draw the dummies as the reference draws them
    (`prng.normal`, so both packages start from the same values).
    Returns (reconstructed_x, match_loss_history)."""
    dev = _device(params)
    kx, ky = prng.split(key)
    x = prng.normal(kx, tuple(x_shape), dev) * 0.1
    y = prng.normal(ky, (x_shape[0], n_classes), dev) * 0.1
    mx, vx = torch.zeros_like(x), torch.zeros_like(x)
    my, vy = torch.zeros_like(y), torch.zeros_like(y)
    b1, b2, eps = 0.9, 0.999, 1e-8
    hist = []

    def adam(p, g, m, v, t):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (np.float32(1.0) - powf(np.float32(b1), t))
        vh = v / (np.float32(1.0) - powf(np.float32(b2), t))
        return p - lr * mh / (torch.sqrt(vh) + eps), m, v

    for step in range(1, steps + 1):
        xv = x.detach().requires_grad_(True)
        yv = y.detach().requires_grad_(True)
        val = _grad_match_loss(loss_fn, params, xv, yv, true_grads)
        gx, gy = torch.autograd.grad(val, (xv, yv))
        x, mx, vx = adam(x, gx, mx, vx, float(step))
        y, my, vy = adam(y, gy, my, vy, float(step))
        hist.append(val.detach())
    return x.detach(), torch.stack(hist)


def reconstruction_mse(x_true, x_rec) -> torch.Tensor:
    return torch.mean(torch.square(torch.as_tensor(x_true).to(torch.float32)
                                   - torch.as_tensor(x_rec)
                                   .to(torch.float32)))


def attack_success_rate(x_true, x_rec,
                        mse_threshold: float = 0.05) -> torch.Tensor:
    """ASR (Definition 7): the fraction of samples reconstructed below an
    MSE threshold."""
    x_true = torch.as_tensor(x_true).to(torch.float32)
    per = torch.mean(torch.square(x_true - torch.as_tensor(x_rec)
                                  .to(torch.float32)),
                     dim=tuple(range(1, x_true.ndim)))
    return (per < mse_threshold).to(torch.float32).mean()
