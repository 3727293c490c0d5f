"""Model-layout and parameter-tree wrappers over the kernels K4, K5, K6.

Port of `repro.kernels.ops`: `attention_pallas` runs K6 on the model
layout (B, S, H, D); `sparsify_pallas` runs the DGC container update on a
tree at a keep ratio, `aldp_perturb_pallas` the clip-at-S + noise of
Eq. (8), one flat kernel launch per leaf with leaf i seeded
``seed + i·7919``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import tree as tree_util
from ..core.accumulator import leaf_threshold
from ..core.aldp import global_norm
from .flash_attention import flash_attention
from .ldp_noise import ldp_perturb_flat
from .sparsify import sparsify_flat


def attention_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout: q (B, S, H, D); k, v (B, S, KV, D) -> (B, S, H, D).
    The kernel reads the transposed views through their strides and
    writes a (B, S, H, D) tensor, so no copy is made on the card."""
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, window=window, out=out.transpose(1, 2))
    return out


def aldp_perturb_pallas(tree, seed: torch.Tensor, *, sigma: float,
                        clip_s: float):
    """Tree clip-at-S + Gaussian noise, one `ldp_perturb_flat` per leaf.
    ``seed`` is a 0-d int32 tensor.  Returns (perturbed tree, ‖tree‖₂)."""
    nrm = global_norm(tree)
    scale = 1.0 / torch.clamp(nrm / clip_s, min=1.0)
    out = []
    for i, leaf in enumerate(tree_util.leaves(tree)):
        s = ((seed.to(torch.int64) + i * 7919 + 2 ** 31) % 2 ** 32
             - 2 ** 31).to(torch.int32)             # int32 wrap, as jnp
        pert = ldp_perturb_flat(leaf.reshape(-1), s, scale, sigma, clip_s)
        out.append(pert.reshape(leaf.shape).to(leaf.dtype))
    return tree_util.unflatten_like(tree, out), nrm


def sparsify_pallas(grad_tree, residual_tree, *, ratio: float
                    ) -> Tuple[object, object]:
    """DGC container update at keep-``ratio``: one threshold, the |g + r|
    quantile at 1 − ratio over the whole tree (0 when ratio ≥ 1), then
    one `sparsify_flat` launch per leaf.  Returns (upload tree, residual'
    tree)."""
    g_leaves = tree_util.leaves(grad_tree)
    r_leaves = tree_util.leaves(residual_tree)
    if ratio < 1.0:
        combined = torch.cat([g.reshape(-1).to(torch.float32)
                              + r.reshape(-1).to(torch.float32)
                              for g, r in zip(g_leaves, r_leaves)])
        thr = leaf_threshold(combined, ratio)
    else:
        thr = torch.zeros((), dtype=torch.float32,
                          device=g_leaves[0].device)
    ups, news = [], []
    for g, r in zip(g_leaves, r_leaves):
        up, nr = sparsify_flat(g.reshape(-1), r.reshape(-1), thr)
        ups.append(up.reshape(g.shape))
        news.append(nr.reshape(r.shape))
    return (tree_util.unflatten_like(grad_tree, ups),
            tree_util.unflatten_like(residual_tree, news))
