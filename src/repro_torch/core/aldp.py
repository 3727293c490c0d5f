"""Asynchronous Local Differential Privacy (ALDP) mechanism — paper §5.2.

Port of `repro.core.aldp`: the Eq. (8) clip and the (ε, δ) calibration.
The node-side Gaussian noise of the fused pipeline lives in
`kernels.upload_fused` (the counter-hash Box–Muller stream of the
reference's kernel); the reference backend's `jax.random.normal` noise is
not mirrored yet, so that combination raises (see `api.plan`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import tree as tree_util


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_util.leaves(tree)))


def clip_by_global_norm(tree, clip_s: float) -> Tuple[object, torch.Tensor]:
    """Eq. (8) clipping: tree / max(1, ‖tree‖₂/S). Returns (clipped, norm)."""
    nrm = global_norm(tree)
    scale = 1.0 / torch.clamp(nrm / clip_s, min=1.0)
    return tree_util.map(lambda x: (x * scale).to(x.dtype), tree), nrm


def sigma_for_epsilon(epsilon: float, delta: float) -> float:
    """Single-release Gaussian mechanism calibration (Definition 2):
    σ = √(2 log(1.25/δ)) / ε."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def epsilon_for_sigma(sigma: float, delta: float) -> float:
    """Inverse of :func:`sigma_for_epsilon` (single release)."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / sigma
