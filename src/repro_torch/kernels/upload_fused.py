"""Fused upload pipeline (DGC sparsify + nnz + ALDP clip/noise) for a cohort.

Port of `repro.kernels.upload_fused`.  `upload_fused_fleet` keeps the
reference's signature; on CUDA tensors it launches the hand-written
kernel in ``csrc/upload_fused.cu`` (one pass over the (C, N) cohort), on
CPU tensors it runs `upload_fused_plain`, the PyTorch version of the same
arithmetic (the reference's `upload_fused_reference` + `block_noise`).
Besides its launch count, the wrapper tallies the shapes it launched at in
``upload_fused_fleet.shapes``: (C, N, flags) -> launches, where flags is
the kernel's bit set (1 sparsify, 2 clip scale, 4 noise, 8 nnz).

The noise is the reference kernel's counter-hash Box–Muller stream
(`kernels.ldp_noise.block_noise`, the stream K5 draws): node i draws
element e of TPU tile b (a tile is 256 × 1024 flat positions) from
murmur(e + u32(seed_i + b·7919)·2654435761 + stream·0x9E3779B9).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .ldp_noise import block_noise


def spread_thresholds(thresholds: torch.Tensor, boundaries: Sequence[int],
                      n: int) -> torch.Tensor:
    """(C, L) per-leaf thresholds -> (C, N) per-element thresholds under
    the static leaf layout ``boundaries`` (start offsets)."""
    ends = list(boundaries[1:]) + [n]
    sizes = torch.tensor([e - int(b) for b, e in zip(boundaries, ends)],
                         device=thresholds.device)
    return torch.repeat_interleave(thresholds, sizes, dim=1)


def upload_fused_plain(flat, residuals, thresholds, seeds, clip_scales,
                       sigma: float, clip_s: float, *,
                       boundaries: Sequence[int] = (0,),
                       need_nnz: bool = False):
    """Plain PyTorch version of the fused pipeline (the parity oracle)."""
    c, n = flat.shape
    g = flat.to(torch.float32)
    newr = None
    if residuals is not None:
        comb = g + residuals.to(torch.float32)
        keep = comb.abs() >= spread_thresholds(thresholds, boundaries, n)
        zero = torch.zeros((), dtype=torch.float32, device=flat.device)
        up = torch.where(keep, comb, zero)
        newr = torch.where(keep, zero, comb).to(residuals.dtype)
    else:
        up = g
    nnz = (up != 0).sum(1).to(torch.int32) if need_nnz else None
    if clip_scales is not None:
        up = up * clip_scales.to(torch.float32)[:, None]
        sigma_s = float(sigma) * float(clip_s)
        if sigma_s > 0.0:
            up = up + block_noise(seeds, n, sigma_s)
    return up.to(flat.dtype), newr, nnz


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.upload_fused_launch
    if fn.argtypes is None:
        v = ctypes.c_void_p
        fn.argtypes = [v, v, v, v, ctypes.c_int, v, v, ctypes.c_float,
                       v, v, v, ctypes.c_int, ctypes.c_int, ctypes.c_int, v]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _leaf_starts(boundaries: Tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """The leaf start offsets as an int32 device array, made once per
    layout: a fresh host-to-device copy from pageable memory would
    synchronise the stream on every launch."""
    return torch.tensor(boundaries, dtype=torch.int32, device=device)


def upload_fused_fleet(flat: torch.Tensor,
                       residuals: Optional[torch.Tensor],
                       thresholds: Optional[torch.Tensor],
                       seeds: Optional[torch.Tensor],
                       clip_scales: Optional[torch.Tensor],
                       sigma: float, clip_s: float, *,
                       boundaries: Sequence[int] = (0,),
                       need_nnz: bool = False):
    """Whole-cohort fused upload pipeline.

    flat (C, N) f32 stacked per-node deltas; residuals (C, N) or None to
    skip sparsification; thresholds (C, L) per-node per-leaf DGC cutoffs;
    seeds (C,) int32 node-distinct noise seeds; clip_scales (C,) f32 =
    1/max(1, ‖upload‖/S), or None to skip ALDP; boundaries: start offset
    of each leaf.  Returns (upload (C, N), residual' or None, nnz (C,)
    int32 or None)."""
    if flat.device.type == "cpu":
        return upload_fused_plain(flat, residuals, thresholds, seeds,
                                  clip_scales, sigma, clip_s,
                                  boundaries=boundaries, need_nnz=need_nnz)
    if flat.device.type != "cuda":
        raise ValueError(f"upload_fused: unsupported device {flat.device}")
    dev = flat.device
    c, n = flat.shape
    do_sparsify = residuals is not None
    apply_ldp = clip_scales is not None
    sigma_s = float(sigma) * float(clip_s) if apply_ldp else 0.0
    if not 1 <= c <= 65535:
        raise ValueError(f"upload_fused: cohort size {c} outside [1, 65535]")
    check = functools.partial(_build.require, "upload_fused")
    check("flat", flat, (c, n), torch.float32, dev)
    bounds = None
    if do_sparsify:
        check("residuals", residuals, (c, n), torch.float32, dev)
        check("thresholds", thresholds, (c, len(boundaries)), torch.float32,
              dev)
        bounds = _leaf_starts(tuple(int(b) for b in boundaries), dev)
    if sigma_s > 0.0:
        check("seeds", seeds, (c,), torch.int32, dev)
    if apply_ldp:
        check("clip_scales", clip_scales, (c,), torch.float32, dev)
    flat, residuals = _build.aligned(flat), _build.aligned(residuals)
    lib = _configure(_build.load("upload_fused"))
    up = torch.empty_like(flat)
    newr = torch.empty_like(flat) if do_sparsify else None
    nnz = torch.zeros(c, dtype=torch.int32, device=dev) if need_nnz else None
    flags = (do_sparsify | apply_ldp << 1 | (sigma_s > 0.0) << 2
             | need_nnz << 3)
    p = _build.ptr
    rc = lib.upload_fused_launch(
        p(flat), p(residuals), p(thresholds), p(bounds),
        len(boundaries), p(seeds if sigma_s > 0.0 else None),
        p(clip_scales), ctypes.c_float(sigma_s), p(up), p(newr), p(nnz),
        c, n, flags, _build.stream(dev))
    _build.check(rc, lib, "upload_fused_error_string")
    upload_fused_fleet.launches += 1
    upload_fused_fleet.shapes[(c, n, flags)] += 1
    return up, newr, nnz


upload_fused_fleet.launches = 0
upload_fused_fleet.shapes = collections.Counter()
