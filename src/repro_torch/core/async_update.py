"""Asynchronous model-update scheme — paper §5.1 (Eq. 6) and §5.3.

Port of `repro.core.async_update`: ω ← α·ω + (1−α)·ω_new, the FedAsync
staleness-adaptive weight, and κ (Eq. 5)."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from .. import tree as tree_util


def mix(global_tree, new_tree, alpha):
    """Eq. (6): ω ← α·ω + (1−α)·ω_new (leafwise convex combination)."""
    return tree_util.map(
        lambda g, n: (alpha * g.to(torch.float32)
                      + (1.0 - alpha) * n.to(torch.float32)).to(g.dtype),
        global_tree, new_tree)


@functools.lru_cache(maxsize=None)
def _libm_powf():
    path = ctypes.util.find_library("m")
    if path is None:
        raise RuntimeError("staleness_alpha needs the C math library's powf")
    fn = ctypes.CDLL(path).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def powf(x: float, e: float) -> np.float32:
    """The C library's float32 ``powf``, which XLA's CPU backend lowers a
    float32 power to (with pow(x, −1) rewritten to 1/x by the caller)."""
    return np.float32(_libm_powf()(float(x), float(e)))


def staleness_alpha(alpha: float, staleness: int,
                    a: float = 0.5) -> torch.Tensor:
    """FedAsync weight of the new model: (1−α)·(τ+1)^(−a) in float32, for
    the integer τ the engines pass, bitwise as the reference's compiled
    program computes it.  XLA's CPU backend rewrites pow(x, −1) to 1/x and
    lowers every other float32 power to the C library's ``powf``, which
    `torch.pow` and numpy's float32 power do not reproduce (they are not
    correctly rounded in the same places); the weight is one host scalar
    per arrival, so it is computed here with the same ``powf``."""
    x = np.float32(np.float32(staleness) + np.float32(1.0))
    e = np.float32(-a)
    p = (np.float32(1.0) / x if e == -1.0
         else powf(x, e))
    return torch.tensor(np.float32(1.0 - alpha) * p, dtype=torch.float32)


def mix_stale(global_tree, new_tree, alpha: float, staleness,
              a: float = 0.5):
    w_new = staleness_alpha(alpha, staleness, a)
    return tree_util.map(
        lambda g, n: ((1.0 - w_new) * g.to(torch.float32)
                      + w_new * n.to(torch.float32)).to(g.dtype),
        global_tree, new_tree)


def communication_efficiency(comm_time: float, comp_time: float) -> float:
    """Eq. (5): κ = Comm / (Comp + Comm)."""
    denom = comm_time + comp_time
    return comm_time / denom if denom > 0 else 0.0
