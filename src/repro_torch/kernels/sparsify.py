"""DGC split of a stacked cohort at one threshold per row (kernel K4).

Port of `repro.kernels.sparsify`: combined = g + residual; elements with
|combined| ≥ threshold are uploaded, the rest stay in the residual.
`sparsify_fleet` keeps the reference's signature; on CUDA tensors it
launches the hand-written kernel in ``csrc/sparsify.cu``, on CPU tensors
it runs `sparsify_plain`.  `sparsify_flat` is the one-row case.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def sparsify_plain(grads, residuals, thresholds):
    """Plain PyTorch version: (K, N) ×2, thresholds (K,) -> (upload,
    residual'), each (K, N)."""
    c = grads.to(torch.float32) + residuals.to(torch.float32)
    keep = c.abs() >= thresholds.to(torch.float32)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    return (torch.where(keep, c, zero).to(grads.dtype),
            torch.where(keep, zero, c).to(residuals.dtype))


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.sparsify_launch
    if fn.argtypes is None:
        v = ctypes.c_void_p
        fn.argtypes = [v, v, v, v, v, ctypes.c_int, ctypes.c_longlong, v]
        fn.restype = ctypes.c_int
    return lib


def sparsify_fleet(grads: torch.Tensor, residuals: torch.Tensor,
                   thresholds: torch.Tensor):
    """Whole-cohort DGC split in one launch.

    grads, residuals (K, N) f32; thresholds (K,) f32 per-node magnitude
    cutoffs.  Returns (uploads (K, N), residuals' (K, N))."""
    if grads.device.type == "cpu":
        return sparsify_plain(grads, residuals, thresholds)
    if grads.device.type != "cuda":
        raise ValueError(f"sparsify: unsupported device {grads.device}")
    dev = grads.device
    k, n = grads.shape
    if not 1 <= k <= 65535 or n < 1:
        raise ValueError(f"sparsify: shape {(k, n)} outside [1, 65535] x "
                         f"[1, ...)")
    for name, t, shape in (("grads", grads, (k, n)),
                           ("residuals", residuals, (k, n)),
                           ("thresholds", thresholds, (k,))):
        _build.require("sparsify", name, t, shape, torch.float32, dev)
    lib = _configure(_build.load("sparsify"))
    up = torch.empty_like(grads)
    newr = torch.empty_like(residuals)
    p = _build.ptr
    rc = lib.sparsify_launch(
        p(grads), p(residuals), p(thresholds), p(up), p(newr), k, n,
        _build.stream(dev))
    _build.check(rc, lib, "sparsify_error_string")
    sparsify_fleet.launches += 1
    return up, newr


sparsify_fleet.launches = 0


def sparsify_flat(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: torch.Tensor):
    """One row: grad, residual (N,); threshold () f32 -> (upload (N,),
    residual' (N,)) — one `sparsify_fleet` launch."""
    up, newr = sparsify_fleet(grad.reshape(1, -1), residual.reshape(1, -1),
                              threshold.reshape(1))
    return up.reshape(grad.shape), newr.reshape(residual.shape)
