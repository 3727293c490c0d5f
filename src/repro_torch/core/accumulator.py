"""Local gradient accumulation + magnitude-first upload — paper §5.1.

Port of `repro.core.accumulator`.  Each node keeps a residual tree; at
upload time residual + new delta is split into a sparse large-magnitude
part (uploaded) and a small-magnitude part (kept).  The threshold rule is
`jnp.quantile`'s linear interpolation, reproduced in the reference's
arithmetic order so the keep set is bitwise the reference's
(`torch.quantile` refuses inputs above 2^24 elements and rounds
differently).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import tree as tree_util
from ..net.codecs import analytic_upload_bytes
from .numerics import interp_lo_first


def leaf_threshold(rows: torch.Tensor, ratio: float) -> torch.Tensor:
    """The DGC magnitude cutoff of each row: the |value| quantile at
    1 − ratio over the last axis ((..., n) -> (...,)).

    Mirrors `jnp.quantile` as the engines compile it: q = f32(1 − ratio)
    · (n − 1) in float32, floor/ceil neighbours of the sorted |values|,
    and the interpolation contracted as fma(lo, lw, hi·hw)."""
    a = rows.abs().to(torch.float32)
    n = a.shape[-1]
    srt = torch.sort(a, dim=-1).values
    q = float(np.float32(1.0 - ratio)
              * np.float32(np.float32(n) - np.float32(1.0)))
    lo_i = min(max(int(np.floor(q)), 0), n - 1)
    hi_i = min(max(int(np.ceil(q)), 0), n - 1)
    hw = np.float32(q - np.floor(q))
    lw = np.float32(np.float32(1.0) - hw)
    dev = rows.device
    return interp_lo_first(srt[..., lo_i], torch.tensor(lw, device=dev),
                           srt[..., hi_i], torch.tensor(hw, device=dev))


def sparsify_rows(combined: torch.Tensor, ratio: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-`ratio` fraction of each row by |value|; the rest
    becomes the residual.  combined (..., n)."""
    if ratio >= 1.0:
        return combined, torch.zeros_like(combined)
    thr = leaf_threshold(combined, ratio)[..., None]
    keep = combined.abs() >= thr
    zero = torch.zeros((), dtype=combined.dtype, device=combined.device)
    return torch.where(keep, combined, zero), torch.where(keep, zero,
                                                          combined)


def sparsify_leaf(combined: torch.Tensor, ratio: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`repro.core.accumulator.sparsify_leaf`: one leaf, any shape."""
    up, res = sparsify_rows(combined.reshape(-1), ratio)
    return up.reshape(combined.shape), res.reshape(combined.shape)


def accumulate_and_sparsify(residual, grad, ratio: float, node_axis=False):
    """Returns (upload tree, new residual tree, upload fraction, a 0-d
    tensor: reading it waits for the device).

    With ``node_axis`` every leaf carries a leading node axis and each
    node's rows are thresholded on their own (the reference vmaps the
    single-node function over the cohort)."""
    combined = tree_util.map(lambda r, g: r + g.to(torch.float32),
                             residual, grad)

    def split(c):
        if not node_axis:
            return sparsify_leaf(c, ratio)
        up, res = sparsify_rows(c.reshape(c.shape[0], -1), ratio)
        return up.reshape(c.shape), res.reshape(c.shape)

    pairs = [split(c) for c in tree_util.leaves(combined)]
    upload = tree_util.unflatten_like(combined, [p[0] for p in pairs])
    new_residual = tree_util.unflatten_like(combined, [p[1] for p in pairs])
    nnz = sum((u != 0).sum() for u in tree_util.leaves(upload))
    return upload, new_residual, nnz / tree_util.size(upload)


def upload_bytes(tree, ratio: float, bytes_per_value: int = 4,
                 bytes_per_index: int = 4) -> int:
    """Analytic wire size of a sparsified upload (values + indices), from
    `net.codecs.analytic_upload_bytes`, as `fleet.stages.bytes_per_node`
    prices it."""
    return analytic_upload_bytes(tree_util.size(tree), ratio,
                                 bytes_per_value, bytes_per_index)
