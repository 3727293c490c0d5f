"""Functional optimizers on nested dicts of tensors.

Port of `repro.optim.optimizers`: each optimizer has ``init(params) ->
state`` and ``update(params, grads, state) -> (params, state)``; states
are tensor trees (plus the step count as a 0-d int32 tensor), so they
checkpoint like params.  SGD is the paper's FedSGD and keeps no state.

The arithmetic is the reference's, op by op as jnp evaluates it eagerly:
a Python float meets a tensor as a weakly typed scalar, so ``lr * g``
rounds lr to the grad's dtype first (bfloat16 for a bfloat16 leaf), and
the moments are float32 whatever the param's dtype.  AdamW's bias
corrections 1 − β^t take the C library's ``powf``, as XLA lowers a
float32 power, and its square root is correctly rounded, as XLA's is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import tree as tree_util
from ..core.async_update import powf


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as jnp types it against ``like``: rounded to its
    dtype (a 0-d tensor, so it does not promote ``like``)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (PyTorch's CPU one is not)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _zeros_f32(params):
    return tree_util.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


@dataclass(frozen=True)
class SGD:
    lr: float = 1e-2

    def init(self, params):
        return ()

    def update(self, params, grads, state) -> Tuple[object, object]:
        def step(p, g):
            g = g.to(p.dtype)
            return (p - g * _weak(self.lr, g)).to(p.dtype)
        return tree_util.map(step, params, grads), state


@dataclass(frozen=True)
class Momentum:
    lr: float = 1e-2
    beta: float = 0.9

    def init(self, params):
        return {"m": _zeros_f32(params)}

    def update(self, params, grads, state):
        m = tree_util.map(lambda m_, g: m_ * _weak(self.beta, m_)
                          + g.to(torch.float32), state["m"], grads)
        new = tree_util.map(lambda p, m_: (p - m_ * _weak(self.lr, m_))
                            .to(p.dtype), params, m)
        return new, {"m": m}


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        dev = tree_util.leaves(params)[0].device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, params, grads, state):
        t = state["t"] + 1
        f = np.float32
        m = tree_util.map(
            lambda m_, g: m_ * _weak(self.b1, m_)
            + g.to(torch.float32) * _weak(1 - self.b1, m_), state["m"], grads)
        v = tree_util.map(
            lambda v_, g: v_ * _weak(self.b2, v_)
            + torch.square(g.to(torch.float32)) * _weak(1 - self.b2, v_),
            state["v"], grads)
        step = float(f(int(t)))
        bc1 = f(1) - powf(float(f(self.b1)), step)
        bc2 = f(1) - powf(float(f(self.b2)), step)

        def upd(p, m_, v_):
            s = (m_ / _weak(bc1, m_)) * _weak(self.lr, m_) / (
                _sqrt_f32(v_ / _weak(bc2, v_)) + _weak(self.eps, v_))
            if self.weight_decay:
                s = s + p.to(torch.float32) * _weak(
                    self.lr * self.weight_decay, m_)
            return (p - s).to(p.dtype)

        new = tree_util.map(upd, params, m, v)
        return new, {"m": m, "v": v, "t": t}


def make_optimizer(name: str, lr: float, **kw):
    name = name.lower()
    if name == "sgd":
        return SGD(lr=lr)
    if name == "momentum":
        return Momentum(lr=lr, **kw)
    if name == "adamw":
        return AdamW(lr=lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
