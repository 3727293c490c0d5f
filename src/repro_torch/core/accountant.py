"""Moments accountant (Abadi et al. 2016) via Rényi DP composition.

Tracks the privacy loss of repeated (possibly subsampled) Gaussian-mechanism
releases — the paper uses this to "evaluate δ given ε, σ and K" (§5.2).

Implementation: integer-order RDP of the subsampled Gaussian mechanism
(Mironov/Wang; the same formula TF-Privacy uses for integer α), composed
linearly over steps, converted with ε(δ) = min_α [ RDP(α) + log(1/δ)/(α−1) ].
Pure numpy host-side bookkeeping; a copy of `repro.core.accountant`.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

DEFAULT_ORDERS = tuple(range(2, 64)) + (128, 256, 512)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def rdp_gaussian(sigma: float, alpha: int) -> float:
    """RDP of the (unsampled) Gaussian mechanism with noise multiplier σ."""
    return alpha / (2.0 * sigma ** 2)


def rdp_subsampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """Integer-α RDP of the Poisson-subsampled Gaussian mechanism."""
    if q == 0:
        return 0.0
    if q >= 1.0:
        return rdp_gaussian(sigma, alpha)
    # log( sum_k C(alpha,k) (1-q)^(alpha-k) q^k exp(k(k-1)/(2 sigma^2)) )
    terms = []
    for k in range(alpha + 1):
        log_t = (_log_comb(alpha, k) + (alpha - k) * math.log1p(-q)
                 + k * math.log(q) + k * (k - 1) / (2.0 * sigma ** 2))
        terms.append(log_t)
    m = max(terms)
    log_sum = m + math.log(sum(math.exp(t - m) for t in terms))
    return log_sum / (alpha - 1)


def eps_from_rdp(rdp: Sequence[float], orders: Sequence[int], delta: float) -> float:
    eps = [r + math.log(1.0 / delta) / (a - 1) for r, a in zip(rdp, orders)]
    return max(min(eps), 0.0)


class MomentsAccountant:
    """Accumulates RDP over training rounds; queries ε(δ) or δ(ε).

    Args:
      sigma: noise multiplier (noise stddev = sigma * clip_S).
      sampling_rate: per-round probability a given node/example participates
        (paper: m/K nodes sampled per round).
    """

    def __init__(self, sigma: float, sampling_rate: float = 1.0,
                 orders: Iterable[int] = DEFAULT_ORDERS):
        if sigma <= 0:
            raise ValueError(
                f"MomentsAccountant needs sigma > 0 (got {sigma}); a "
                "zero-noise run spends no privacy budget — don't construct "
                "an accountant for it.")
        self.sigma = float(sigma)
        self.q = float(sampling_rate)
        self.orders = tuple(orders)
        self._rdp = np.zeros(len(self.orders))
        self.steps = 0

    def step(self, n: int = 1) -> None:
        inc = np.array([rdp_subsampled_gaussian(self.q, self.sigma, a)
                        for a in self.orders])
        self._rdp += n * inc
        self.steps += n

    def epsilon(self, delta: float) -> float:
        if self.steps == 0:
            return 0.0
        return eps_from_rdp(self._rdp, self.orders, delta)

    def delta(self, epsilon: float) -> float:
        """Smallest δ achieving the target ε under the accumulated RDP."""
        if self.steps == 0:
            return 0.0
        log_deltas = [(a - 1) * (r - epsilon) for r, a in zip(self._rdp, self.orders)]
        return float(min(1.0, math.exp(min(log_deltas))))
