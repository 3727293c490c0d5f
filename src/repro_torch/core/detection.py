"""Cloud-side malicious-node detection — paper §5.4, Algorithm 2.

Port of `repro.core.detection`.  The threshold is the s-th percentile of
the accuracy set; the verdicts A > Thr are only reproducible if Thr is
bitwise the reference's, and plain `torch.quantile` is not (it flips a
few percent of verdicts on accuracies drawn from a 1/n grid).  The
percentiles below therefore mirror the float32 arithmetic XLA compiles
for `jnp.percentile` / `jnp.nanpercentile`, which depends on the
context the reference evaluates them in:

  * `detection_threshold` — called eagerly by the reference's sequential
    loop: q = s·(0.01·(n − 1)), interpolation fma(hi, hw, lo·lw);
  * `nanpercentile` (ring threshold, masked cohort threshold) — compiled
    inside the engines' jitted programs with a runtime sample count:
    q = (s / 100)·(count − 1), interpolation fma(hi, hw, lo·lw).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import tree as tree_util
from .numerics import interp_hi_first


def _gather_interp(srt: torch.Tensor, q: torch.Tensor, n: torch.Tensor
                   ) -> torch.Tensor:
    """Linear interpolation of sorted 1-D ``srt`` at float32 position q,
    indices clamped to [0, n − 1] (n may be a tensor count)."""
    lo = torch.floor(q)
    hi = torch.ceil(q)
    hw = q - lo
    lw = torch.ones_like(hw) - hw
    top = (n - 1).to(torch.float32)
    zero = torch.zeros_like(lo)
    lo_i = torch.maximum(zero, torch.minimum(lo, top)).to(torch.int64)
    hi_i = torch.maximum(zero, torch.minimum(hi, top)).to(torch.int64)
    return interp_hi_first(srt[lo_i], lw, srt[hi_i], hw)


def detection_threshold(accuracies: torch.Tensor, s: float) -> torch.Tensor:
    """Thr ← top-s% of 𝒜 (the s-th percentile of the accuracy set)."""
    a = accuracies.to(torch.float32).reshape(-1)
    n = a.shape[0]
    srt = torch.sort(a).values
    q = float(np.float32(np.float32(s) * np.float32(
        np.float32(0.01) * np.float32(n - 1))))
    return _gather_interp(srt, torch.tensor(q, device=a.device),
                          torch.tensor(n, device=a.device))


def nanpercentile(values: torch.Tensor, s: float) -> torch.Tensor:
    """`jnp.nanpercentile(values, s)` of a 1-D float32 vector as the
    engines compile it (NaN entries are excluded)."""
    v = values.to(torch.float32).reshape(-1)
    srt = torch.sort(v).values                  # NaNs sort last
    count = (~torch.isnan(v)).sum().to(torch.float32)
    q = (torch.tensor(float(np.float32(s) / np.float32(100.0)),
                      device=v.device)
         * (count - torch.ones_like(count)))
    return _gather_interp(srt, q, count)


def detect(accuracies: torch.Tensor, s: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (normal_mask (N,) bool, threshold): A_j > Thr ⇒ normal,
    falling back to ``>=`` when the strict test rejects everyone."""
    thr = detection_threshold(accuracies, s)
    mask = accuracies > thr
    if not bool(mask.any()):
        mask = accuracies >= thr
    return mask, thr


def masked_mean(trees, mask: torch.Tensor):
    """Aggregate node updates over normal nodes only (Alg. 2 line 16)."""
    w = mask.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)

    def agg(x):
        wf = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return (x.to(torch.float32) * wf).sum(0) / denom

    return tree_util.map(agg, trees)


def detect_fell_back(accuracies, thr, valid=None) -> bool:
    """Did the all-equal guard fire (no valid node cleared A > Thr)?"""
    accs = np.asarray(accuracies)
    strict = accs > np.asarray(thr)
    if valid is not None:
        strict = strict & np.asarray(valid, bool)
    return not bool(strict.any())


# ---------------------------------------------------------------------------
# streaming detection window (asynchronous Alg. 2): a ring of the most
# recent accuracies, NaN marking never-written slots, ``count`` the total
# number of pushes (write cursor = count % window)
# ---------------------------------------------------------------------------

def default_window(n_nodes: int) -> int:
    """Default async sliding-window length: one full fleet pass, floored
    so tiny fleets still collect enough accuracies to threshold."""
    return max(n_nodes, 4)


def ring_push(ring: torch.Tensor, count: int, value) -> Tuple[torch.Tensor,
                                                               int]:
    """Append one accuracy, overwriting the oldest once the ring is full."""
    ring = ring.clone()
    ring[count % ring.shape[0]] = value
    return ring, count + 1


def ring_threshold(ring: torch.Tensor, count: int, s: float) -> torch.Tensor:
    """Thr ← top-s% of the occupied ring slots."""
    occupied = torch.arange(ring.shape[0], device=ring.device) < count
    return nanpercentile(torch.where(occupied, ring,
                                     torch.full_like(ring, float("nan"))), s)


def ring_detect(ring: torch.Tensor, count: int, acc, s: float,
                warmup: int) -> bool:
    """Is the arrival with cloud accuracy ``acc`` (already pushed)
    rejected?  Only once ``warmup`` accuracies are held."""
    held = min(count, ring.shape[0])
    return held >= warmup and bool(acc <= ring_threshold(ring, count, s))
