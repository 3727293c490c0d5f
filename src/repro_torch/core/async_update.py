"""Asynchronous model-update scheme — paper §5.1 (Eq. 6) and §5.3.

Port of `repro.core.async_update`: ω ← α·ω + (1−α)·ω_new, the FedAsync
staleness-adaptive weight, and κ (Eq. 5)."""
from __future__ import annotations

import torch

from .. import tree as tree_util


def mix(global_tree, new_tree, alpha):
    """Eq. (6): ω ← α·ω + (1−α)·ω_new (leafwise convex combination)."""
    return tree_util.map(
        lambda g, n: (alpha * g.to(torch.float32)
                      + (1.0 - alpha) * n.to(torch.float32)).to(g.dtype),
        global_tree, new_tree)


def staleness_alpha(alpha: float, staleness, a: float = 0.5) -> torch.Tensor:
    """FedAsync weight of the new model: (1−α)·(τ+1)^(−a) in float32."""
    tau = torch.as_tensor(staleness, dtype=torch.float32)
    return (1.0 - alpha) * torch.pow(tau + 1.0, -a)


def mix_stale(global_tree, new_tree, alpha: float, staleness,
              a: float = 0.5):
    w_new = staleness_alpha(alpha, staleness, a)
    return tree_util.map(
        lambda g, n: ((1.0 - w_new) * g.to(torch.float32)
                      + w_new * n.to(torch.float32)).to(g.dtype),
        global_tree, new_tree)


def communication_efficiency(comm_time: float, comp_time: float) -> float:
    """Eq. (5): κ = Comm / (Comp + Comm)."""
    denom = comm_time + comp_time
    return comm_time / denom if denom > 0 else 0.0
