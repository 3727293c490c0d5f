"""Asynchronous Local Differential Privacy (ALDP) mechanism — paper §5.2.

Port of `repro.core.aldp`: the Eq. (8) clip, the node-side Gaussian
noise of the reference backend and the (ε, δ) calibration.  The noise is
the reference's `jax.random.normal` stream, drawn on the device
(`prng.bits_tensor` → uniform → XLA's float32 `erf_inv`): each node's key
splits into one key per leaf, and leaf i's draws run over its flattened
shape.  The pallas backend's noise is the fused kernel's counter-hash
stream instead (`kernels.upload_fused`).

The arithmetic follows the reference's compiled engines, where XLA folds
σS into the normal's √2 and contracts the clip's multiply with the noise
add: upload = fma(x, scale, erf_inv(u) · f32(√2 · σS)).  The tree-level
`add_gaussian_noise` (the LLM round's noise, `core.fed_step`) draws leaf
by leaf, `NOISE_CHUNK` counters at a time, so a 0.4 B-param tree needs
the chain's temporaries of one chunk, not of the whole tree.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from .numerics import fma_f32

# Counters the noise chain draws at once: its int64 and float64
# temporaries take about 155 bytes a counter (2.6 GB at 2^24 on an H100),
# so about 0.65 GB at 2^22, whatever the tree's size.
NOISE_CHUNK = 1 << 22


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_util.leaves(tree)))


def clip_by_global_norm(tree, clip_s: float) -> Tuple[object, torch.Tensor]:
    """Eq. (8) clipping: tree / max(1, ‖tree‖₂/S). Returns (clipped, norm)."""
    nrm = global_norm(tree)
    scale = 1.0 / torch.clamp(nrm / clip_s, min=1.0)
    # x · scale in float32, then the leaf's dtype, as jnp promotes a
    # bfloat16 leaf against the float32 scale
    return tree_util.map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                         tree), nrm


def leaf_bits(keys, sizes: Sequence[int], device) -> torch.Tensor:
    """The 32-bit draws behind the reference's per-leaf noise, flat: node
    keys (C, 2) -> (C, P) int64, where leaf i of node c (``sizes[i]``
    elements, in leaf order) draws from split(key_c, L)[i] over counters
    0 .. sizes[i] − 1, as `jax.random.normal(k, leaf.shape)` does.  One
    launch chain for the whole cohort: every element gathers its leaf's
    key words and its counter within the leaf."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    words = torch.as_tensor(prng.split(keys, len(sizes)).astype(np.int64),
                            device=device)                  # (C, L, 2)
    n = torch.as_tensor(list(sizes), dtype=torch.int64, device=device)
    leaf = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), n)          # (P,)
    start = (torch.cumsum(n, 0) - n).index_select(0, leaf)
    counters = torch.arange(leaf.shape[0], device=device) - start
    return prng.bits_tensor(words[:, :, 0].index_select(1, leaf),
                            words[:, :, 1].index_select(1, leaf), counters)


def _as_cohort(tree, key):
    """A tree and its key(s) as the flat cohort the noise runs on: (flat
    (C, P) f32, keys (C, 2), leaf sizes, and the map back to the tree).
    A (C, 2) key means every leaf carries a leading node axis (the
    reference vmaps its single-node functions over it); one (2,) key, a
    single node."""
    key = np.asarray(key, np.uint32)
    batched = key.ndim == 2
    if not batched:
        tree = tree_util.map(lambda x: x[None], tree)
    leaves = tree_util.leaves(tree)
    sizes = [x[0].numel() for x in leaves]
    flat = torch.cat([x.reshape(x.shape[0], -1).to(torch.float32)
                      for x in leaves], dim=1)

    def back(out: torch.Tensor):
        parts = torch.split(out, sizes, dim=1)
        res = tree_util.unflatten_like(tree, [
            p.reshape(x.shape).to(x.dtype) for p, x in zip(parts, leaves)])
        return res if batched else tree_util.map(lambda x: x[0], res)

    return flat, key.reshape(-1, 2), sizes, back


def _noised(x: torch.Tensor, z: torch.Tensor, c: np.float32) -> torch.Tensor:
    """x + σS·n for erf_inv draws ``z``: fma(z, c, x) for a float32 leaf
    (the compiled form); for a narrower leaf the noise is rounded to the
    leaf's dtype before the add, as the reference's
    ``x + σS·normal(...).astype(x.dtype)``."""
    if x.dtype == torch.float32:
        return fma_f32(z, c, x)
    return x + (z * float(c)).to(x.dtype)


def add_gaussian_noise(tree, key, sigma: float, clip_s: float):
    """Adds N(0, (σS)²) to every coordinate.  ``key`` is one uint32 (2,)
    key, or (C, 2) with a leading node axis on every leaf.  Leaf i of node
    c draws from split(key_c, L)[i] over counters 0 .. size − 1 (the bits
    of `leaf_bits`), `NOISE_CHUNK` of them at a time."""
    key = np.asarray(key, np.uint32)
    batched = key.ndim == 2
    leaves = tree_util.leaves(tree)
    words = prng.split(key.reshape(-1, 2), len(leaves))     # (C, L, 2)
    c = prng.normal_scale(sigma * clip_s)
    out = []
    for i, x in enumerate(leaves):
        flat = (x if batched else x[None]).reshape(words.shape[0], -1)
        res = torch.empty_like(flat)
        n = flat.shape[1]
        for node in range(flat.shape[0]):
            k1, k2 = (torch.tensor(int(w), dtype=torch.int64,
                                   device=x.device) for w in words[node, i])
            for lo in range(0, n, NOISE_CHUNK):
                hi = min(lo + NOISE_CHUNK, n)
                cnt = torch.arange(lo, hi, dtype=torch.int64,
                                   device=x.device)
                z = prng.erf_inv_draws(prng.bits_tensor(k1, k2, cnt))
                res[node, lo:hi] = _noised(flat[node, lo:hi], z, c)
        out.append(res.reshape(x.shape))
    return tree_util.unflatten_like(tree, out)


def per_leaf_norms(flat: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """(C, P) -> (C,) L2 norms summed leaf by leaf, in leaf order, as the
    reference's `global_norm` sums them."""
    total, off = 0, 0
    for size in sizes:
        total = total + torch.sum(torch.square(flat[:, off:off + size]),
                                  dim=1)
        off += size
    return torch.sqrt(total)


def perturb_flat(flat: torch.Tensor, keys, sizes: Sequence[int],
                 sigma: float, clip_s: float):
    """Full node-side ALDP on a flat (C, P) cohort: the per-leaf clip norm,
    then fma(x, scale, σS·n).  Returns (perturbed (C, P), norms (C,))."""
    nrm = per_leaf_norms(flat, sizes)
    scale = 1.0 / torch.clamp(nrm / clip_s, min=1.0)
    noise = prng.normal_from_bits(leaf_bits(keys, sizes, flat.device),
                                  sigma * clip_s)
    return fma_f32(flat, scale[:, None], noise), nrm


def aldp_perturb(tree, key, sigma: float, clip_s: float):
    """Full node-side ALDP: clip at S then add N(0, σ²S²). Returns
    (perturbed_tree, pre_clip_norm); ``key`` as in `add_gaussian_noise`."""
    flat, keys, sizes, back = _as_cohort(tree, key)
    out, nrm = perturb_flat(flat, keys, sizes, sigma, clip_s)
    return back(out), nrm if np.asarray(key).ndim == 2 else nrm[0]


def sigma_for_epsilon(epsilon: float, delta: float) -> float:
    """Single-release Gaussian mechanism calibration (Definition 2):
    σ = √(2 log(1.25/δ)) / ε."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def epsilon_for_sigma(sigma: float, delta: float) -> float:
    """Inverse of :func:`sigma_for_epsilon` (single release)."""
    return math.sqrt(2.0 * math.log(1.25 / delta)) / sigma
