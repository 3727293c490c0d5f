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
from .numerics import fma_f32, interp_hi_first


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
    mask = torch.where(mask.any(), mask, accuracies >= thr)
    return mask, thr


def masked_mean(trees, mask: torch.Tensor):
    """Aggregate node updates over normal nodes only (Alg. 2 line 16)."""
    w = mask.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)

    def agg(x):
        wf = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return (x.to(torch.float32) * wf).sum(0) / denom

    return tree_util.map(agg, trees)


def masked_weighted_mean(trees, mask: torch.Tensor, weights: torch.Tensor):
    """Σ w_i x_i / Σ w_i over normal nodes (w zeroed outside ``mask``).
    With uniform weights this is `masked_mean` bit for bit: the masked
    weight sum is the participant count, and the ops are the same."""
    w = mask.to(torch.float32) * weights.to(torch.float32)
    total = w.sum()
    denom = torch.where(total > 0, total, torch.ones_like(total))

    def agg(x):
        wf = w.reshape((-1,) + (1,) * (x.ndim - 1))
        return (x.to(torch.float32) * wf).sum(0) / denom

    return tree_util.map(agg, trees)


# ---------------------------------------------------------------------------
# trust scores (defense.kind="trust_weighted"): an EWMA of the verdicts
# per node, floored and discounted by |A_j − ref| as aggregation weights
# ---------------------------------------------------------------------------

def trust_update(trust: torch.Tensor, accepted: torch.Tensor,
                 seen: torch.Tensor, eta: float) -> torch.Tensor:
    """trust += eta·(verdict − trust) for the nodes ``seen`` (verdict 1 if
    accepted, 0 if rejected), contracted as the reference's compiled
    engines compute it; everyone else keeps their score."""
    target = accepted.to(torch.float32)
    stepped = fma_f32(np.float32(eta), target - trust, trust)
    return torch.where(seen, stepped, trust)


def trust_weights(trust: torch.Tensor, accuracies: torch.Tensor,
                  mask: torch.Tensor, floor: float, uncertainty_scale: float,
                  ref: torch.Tensor = None) -> torch.Tensor:
    """max(trust, floor) / (1 + scale·|A_j − ref|), the denominator
    contracted as in the reference's compiled engines; ``ref`` defaults
    to the accepted cohort's mean accuracy."""
    acc = accuracies.to(torch.float32)
    if ref is None:
        m = mask.to(torch.float32)
        ref = (acc * m).sum() / torch.clamp(m.sum(), min=1.0)
    unc = fma_f32(np.float32(uncertainty_scale), torch.abs(acc - ref),
                  np.float32(1.0))
    return torch.clamp(trust, min=float(floor)) / unc


def staleness_weights(taus, a: float) -> torch.Tensor:
    """(τ+1)^−a per update, float32, as the reference's compiled program
    computes it: pow(x, −1) as 1/x and every other power through the C
    library's ``powf`` (`async_update.powf`), one value per update."""
    from .async_update import powf

    taus = np.maximum(np.asarray(taus), 0)
    x = np.float32(1.0) + taus.astype(np.float32)
    e = np.float32(-float(a))
    if e == -1.0:
        out = np.float32(1.0) / x
    else:
        out = np.array([powf(float(v), float(e)) for v in x.reshape(-1)],
                       np.float32).reshape(x.shape)
    return torch.as_tensor(out, dtype=torch.float32)


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
