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


# ---------------------------------------------------------------------------
# float32 log1p and erf_inv as XLA's CPU backend compiles them (the inverse
# CDF behind `jax.random.normal`)
# ---------------------------------------------------------------------------

def _fma_poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner evaluation p ← fma(p, x, c) from p = 0, the coefficients
    rounded to float32 (XLA's polynomial helper, contracted)."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma_f32(p, x, np.float32(c))
    return p


# Cephes' rational log1p for |x| < √2 − 1, as XLA's elemental emitter
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes' logf, as XLA's CPU backend vectorises it
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 log of positive finite ``v`` as XLA's CPU backend computes
    it (Cephes' logf: mantissa in [√½, √2), a degree-8 polynomial in three
    contracted Horner pieces, the exponent added back in two parts)."""
    f = np.float32
    v = torch.clamp(v, min=float(np.finfo(np.float32).tiny))
    bits = v.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 0x7F).to(torch.float32) + 1.0
    x = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = x < f(0.707106781186547524)
    e = e - small.to(torch.float32)
    x = (x - 1.0) + torch.where(small, x, torch.zeros_like(x))
    x2 = x * x
    x3 = x2 * x
    p = _LOGF_P
    y = fma_f32(fma_f32(x, f(p[0]), f(p[1])), x, f(p[2]))
    y1 = fma_f32(fma_f32(x, f(p[3]), f(p[4])), x, f(p[5]))
    y2 = fma_f32(fma_f32(x, f(p[6]), f(p[7])), x, f(p[8]))
    y = fma_f32(fma_f32(y, x3, y1), x3, y2)
    y = fma_f32(y, x3, _LOGF_Q1 * e)
    x = (x - x2 * 0.5) + y
    return x + _LOGF_Q2 * e


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p of ``x`` in (−1, 0] (where `erf_inv` takes it) as
    XLA's CPU backend computes it: Cephes' rational approximation below
    |x| = √2 − 1, `log_f32(1 + x)` above."""
    xs = x * x
    r = _fma_poly(x, _LOG1P_NUM) / _fma_poly(x, _LOG1P_DEN)
    small = x + (xs * -0.5 + (x * xs) * r)
    large = log_f32(x + 1.0)
    return torch.where(x.abs() < np.float32(0.41421356237309504880), small,
                       large)


# Giles' single-precision erf_inv: w < 5 and w >= 5 branches
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """`jax.lax.erf_inv` in float32 as the reference compiles it on the
    CPU: w = −log1p(−x²); w − 2.5 below 5, √w − 3 above; nine coefficients
    in contracted Horner form; p·x; ±inf at |x| = 1."""
    w = -log1p_f32(x * -x)
    lt = w < 5.0
    # correctly rounded, as XLA's is (PyTorch's float32 CPU sqrt is not)
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    w = torch.where(lt, w - 2.5, root - 3.0)
    p = None
    for lo, hi in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(np.float32(lo), device=x.device),
                        torch.tensor(np.float32(hi), device=x.device))
        p = c if p is None else fma_f32(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)
