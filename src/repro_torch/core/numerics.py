"""Float32 arithmetic that mirrors what XLA's CPU backend compiles.

XLA contracts a multiply feeding an add into one fused multiply-add, so
the reference rounds ``a*b + c`` once where eager PyTorch rounds twice.
`fma_f32` computes the single-rounded result on any device: the float64
product of two float32 values is exact, the float64 sum is rounded to
odd (its error term from TwoSum decides the sticky bit), and rounding
that to float32 is then correct because float64 carries more than twice
float32's precision plus two bits.
"""
from __future__ import annotations

import numpy as np
import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """round_f32(a*b + c) with a single rounding (float32 in and out)."""
    a, b, c = (torch.as_tensor(t).to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def interp_lo_first(lo: torch.Tensor, lw: torch.Tensor, hi: torch.Tensor,
                    hw: torch.Tensor) -> torch.Tensor:
    """``lo*lw + hi*hw`` as XLA compiles it inside a jitted program whose
    quantile fraction is a compile-time constant: fma(lo, lw, hi*hw)."""
    return fma_f32(lo, lw, hi * hw)


def interp_hi_first(lo: torch.Tensor, lw: torch.Tensor, hi: torch.Tensor,
                    hw: torch.Tensor) -> torch.Tensor:
    """``lo*lw + hi*hw`` as XLA compiles it when the fraction is a runtime
    value (eager `jnp.percentile`, the NaN-masked percentiles): fma(hi, hw,
    lo*lw)."""
    return fma_f32(hi, hw, lo * lw)


def f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def mean_compiled(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis as XLA compiles `jnp.mean` inside a jitted
    program: the sum times float32(1/n) (a reciprocal multiply, not a
    division) — the reference's cloud accuracies are exactly these values."""
    n = x.shape[-1]
    return x.to(torch.float32).sum(-1) * float(np.float32(1.0 / n))
