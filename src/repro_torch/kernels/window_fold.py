"""Arrival-ordered window fold of the async engine.

Port of `repro.kernels.window_fold`.  `window_fold_fleet` keeps the
reference's signature; on CUDA tensors it launches the hand-written kernel
in ``csrc/window_fold.cu``, on CPU tensors it runs `window_fold_plain`, a
loop over arrivals with the same arithmetic: the compiled reference
computes each gated step as fma(a, cur, b·omega), reproduced here with
`core.numerics.fma_f32`.  Besides its launch count, the wrapper tallies
the shapes it launched at in ``window_fold_fleet.shapes``: (C, N) ->
launches.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..core.numerics import fma_f32
from . import _build


def window_fold_plain(p_flat, om_flat, gates, a, b):
    """Plain PyTorch fold: returns (final (N,), snapshots (C, N))."""
    cur = p_flat.to(torch.float32)
    om = om_flat.to(torch.float32)
    gates = gates.to(torch.bool).cpu().tolist()
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    seq = []
    for i, on in enumerate(gates):
        if on:
            cur = fma_f32(a[i].expand_as(cur), cur, b[i] * om[i])
        seq.append(cur)
    return cur, torch.stack(seq)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.window_fold_launch
    if fn.argtypes is None:
        v = ctypes.c_void_p
        fn.argtypes = [v, v, v, v, v, v, v, ctypes.c_int, ctypes.c_int, v]
        fn.restype = ctypes.c_int
    return lib


def window_fold_fleet(p_flat: torch.Tensor, om_flat: torch.Tensor,
                      gates: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Fold a window of arrivals into the flattened global params.

    p_flat (N,) f32; om_flat (C, N) f32 per-arrival node models in arrival
    order; gates (C,) bool/int (False = params pass through bitwise);
    a, b (C,) f32 coefficients on (params, omega).  Returns (final params
    (N,), per-arrival snapshots (C, N))."""
    if om_flat.device.type == "cpu":
        return window_fold_plain(p_flat, om_flat, gates, a, b)
    if om_flat.device.type != "cuda":
        raise ValueError(f"window_fold: unsupported device {om_flat.device}")
    dev = om_flat.device
    c, n = om_flat.shape
    if c < 1:
        raise ValueError("window_fold: empty window")
    for name, t, shape in (("p_flat", p_flat, (n,)),
                           ("om_flat", om_flat, (c, n)), ("a", a, (c,)),
                           ("b", b, (c,))):
        _build.require("window_fold", name, t, shape, torch.float32, dev)
    if gates.device != dev or tuple(gates.shape) != (c,):
        raise ValueError(f"window_fold: gates must be ({c},) on {dev}")
    gates = gates.to(torch.int32).contiguous()
    lib = _configure(_build.load("window_fold"))
    seq = torch.empty_like(om_flat)
    out = torch.empty_like(p_flat)
    p = _build.ptr
    rc = lib.window_fold_launch(
        p(p_flat), p(om_flat), p(gates), p(a), p(b), p(seq), p(out), c, n,
        _build.stream(dev))
    _build.check(rc, lib, "window_fold_error_string")
    window_fold_fleet.launches += 1
    window_fold_fleet.shapes[(c, n)] += 1
    return out, seq


window_fold_fleet.launches = 0
window_fold_fleet.shapes = collections.Counter()
