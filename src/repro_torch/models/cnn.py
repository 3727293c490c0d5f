"""The paper's edge model: CNN with 2 convolutional layers + 1 FC layer.

Port of `repro.models.cnn` (paper §6.1).  The public functions keep the
reference's layouts — images NHWC, conv weights HWIO, the FC input in
HWC flatten order — so the same weights give the same logits; inside,
the convolutions run as NCHW/OIHW `conv2d` with the reference's SAME
padding (asymmetric for even sizes at stride 2) applied explicitly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.numerics import mean_compiled


def init_cnn(generator: torch.Generator, in_hw: Tuple[int, int] = (28, 28),
             in_ch: int = 1, n_classes: int = 10, c1: int = 16,
             c2: int = 32, device="cpu") -> dict:
    """Random init from a seeded `torch.Generator` (the same scales as the
    reference; the numbers differ from `jax.random`'s — tests carry
    reference params across with `convert.to_torch`)."""
    h, w = in_hw
    fh, fw = -(-h // 4), -(-w // 4)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32).to(device)

    return {
        "conv1": {"w": normal(3, 3, in_ch, c1) * (1.0 / np.sqrt(9 * in_ch)),
                  "b": torch.zeros(c1, device=device)},
        "conv2": {"w": normal(3, 3, c1, c2) * (1.0 / np.sqrt(9 * c1)),
                  "b": torch.zeros(c2, device=device)},
        "fc": {"w": normal(fh * fw * c2, n_classes)
               * (1.0 / np.sqrt(fh * fw * c2)),
               "b": torch.zeros(n_classes, device=device)},
    }


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 SAME conv, NCHW activations, HWIO weights."""
    ph = _same_pad(x.shape[-2], 3, stride)
    pw = _same_pad(x.shape[-1], 3, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    out = F.conv2d(x, p["w"].permute(3, 2, 0, 1), stride=stride)
    return out + p["b"][:, None, None]


def cnn_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, n_classes)."""
    h = torch.relu(_conv(params["conv1"], x.permute(0, 3, 1, 2), 2))
    h = torch.relu(_conv(params["conv2"], h, 2))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h @ params["fc"]["w"] + params["fc"]["b"]


def cnn_loss(params: dict, batch: dict) -> Tuple[torch.Tensor, dict]:
    logits = cnn_forward(params, batch["x"])
    labels = batch["y"].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll, {"accuracy": acc}


def cnn_accuracy(params: dict, x: torch.Tensor, y: torch.Tensor
                 ) -> torch.Tensor:
    """Top-1 accuracy, with the mean rounded as the compiled reference
    rounds it (`core.numerics.mean_compiled`)."""
    return mean_compiled(cnn_forward(params, x).argmax(-1) == y.long())
