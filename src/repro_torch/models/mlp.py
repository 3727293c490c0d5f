"""Tiny MLP edge model for fleet-scale runs (the `FleetSpec` default).

Port of `repro.models.mlp`: same (params, batch) contract as the CNN."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.numerics import mean_compiled


def init_mlp(generator: torch.Generator, in_dim: int, hidden: int = 32,
             n_classes: int = 10, device="cpu") -> dict:
    """Random init from a seeded `torch.Generator` (numbers differ from the
    reference's `jax.random` draws)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32).to(device)

    return {
        "fc1": {"w": normal(in_dim, hidden) / np.sqrt(in_dim),
                "b": torch.zeros(hidden, device=device)},
        "fc2": {"w": normal(hidden, n_classes) / np.sqrt(hidden),
                "b": torch.zeros(n_classes, device=device)},
    }


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, ...) — trailing dims are flattened — -> logits (B, n_classes)."""
    h = x.reshape(x.shape[0], -1)
    h = torch.tanh(h @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def mlp_loss(params: dict, batch: dict) -> Tuple[torch.Tensor, dict]:
    logits = mlp_forward(params, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"].long()
    loss = -torch.gather(logp, 1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).to(torch.float32).mean()
    return loss, {"accuracy": acc}


def mlp_accuracy(params: dict, x: torch.Tensor, y: torch.Tensor
                 ) -> torch.Tensor:
    """Top-1 accuracy, with the mean rounded as the compiled reference
    rounds it (`core.numerics.mean_compiled`)."""
    logits = mlp_forward(params, x)
    return mean_compiled(logits.argmax(-1) == y.long())
