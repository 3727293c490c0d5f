"""ALDP clip scale + Gaussian noise over a stacked cohort (kernel K5).

Port of `repro.kernels.ldp_noise`.  `ldp_perturb_fleet` keeps the
reference's signature; on CUDA tensors it launches the hand-written
kernel in ``csrc/ldp_noise.cu``, on CPU tensors it runs
`ldp_perturb_plain`.  `ldp_perturb_flat` is the one-row case.

The noise is the reference kernel's counter-hash Box–Muller stream: row i
draws element e of TPU tile b (a tile is 256 × 1024 flat positions) from
murmur(e + u32(seed_i + b·7919)·2654435761 + stream·0x9E3779B9).
`block_noise` computes it in int64 masked to 32 bits; the fused upload
kernel (`kernels.upload_fused`, K1) draws the same stream.  Besides its
launch count, the wrapper tallies the shapes it launched at in
``ldp_perturb_fleet.shapes``: (K, N, σS) -> launches.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build

TILE = 256 * 1024           # the TPU kernel's (256, 1024) block
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for a in [0, 2^32) without int64 overflow."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def block_noise(seeds: torch.Tensor, n: int, sigma_s: float) -> torch.Tensor:
    """The reference kernel's per-tile Box–Muller noise for every row:
    seeds (C,) int32 -> (C, n) float32 (σS-scaled)."""
    dev = seeds.device
    p = torch.arange(n, dtype=torch.int64, device=dev)
    blk = p // TILE
    e = p % TILE
    tiles = torch.arange(max(1, -(-n // TILE)), dtype=torch.int64, device=dev)
    blk_seed = (seeds.to(torch.int64)[:, None] + tiles[None] * 7919) & _M32
    base = _mul32(blk_seed, 2654435761)                     # (C, nb)

    def uniform(stream: int) -> torch.Tensor:
        x = (e[None] + base[:, blk] + ((stream * 0x9E3779B9) & _M32)) & _M32
        x = x ^ (x >> 16)
        x = _mul32(x, 0x7FEB352D)
        x = x ^ (x >> 15)
        x = _mul32(x, 0x846CA68B)
        x = x ^ (x >> 16)
        return (x >> 8).to(torch.float32) / float(1 << 24)

    u1 = torch.clamp(uniform(1), min=1e-12)
    u2 = uniform(2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return sigma_s * r * torch.cos((2.0 * math.pi) * u2)


def ldp_perturb_plain(flat, seeds, clip_scales, sigma: float,
                      clip_s: float) -> torch.Tensor:
    """Plain PyTorch version: clip_scales[:, None]·flat + N(0, (σS)²)."""
    out = flat.to(torch.float32) * clip_scales.to(torch.float32)[:, None]
    sigma_s = float(sigma) * float(clip_s)
    if sigma_s > 0.0:
        out = out + block_noise(seeds, flat.shape[1], sigma_s)
    return out.to(flat.dtype)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.ldp_noise_launch
    if fn.argtypes is None:
        v = ctypes.c_void_p
        fn.argtypes = [v, v, v, ctypes.c_float, v, ctypes.c_int, ctypes.c_int,
                       v]
        fn.restype = ctypes.c_int
    return lib


def ldp_perturb_fleet(flat: torch.Tensor, seeds: torch.Tensor,
                      clip_scales: torch.Tensor, sigma: float,
                      clip_s: float) -> torch.Tensor:
    """Whole-cohort ALDP pass in one launch.

    flat (K, N) f32 stacked per-node deltas; seeds (K,) int32 node-distinct
    noise seeds; clip_scales (K,) f32 = 1/max(1, ‖g_k‖/S).  Returns
    clip_scales[:, None]·flat + N(0, (σS)²), shape and dtype preserved."""
    if flat.device.type == "cpu":
        return ldp_perturb_plain(flat, seeds, clip_scales, sigma, clip_s)
    if flat.device.type != "cuda":
        raise ValueError(f"ldp_noise: unsupported device {flat.device}")
    dev = flat.device
    k, n = flat.shape
    sigma_s = float(sigma) * float(clip_s)
    if not 1 <= k <= 65535 or not 1 <= n < 2 ** 31:
        raise ValueError(f"ldp_noise: shape {(k, n)} outside [1, 65535] x "
                         f"[1, 2^31)")
    for name, t, shape, dtype in (
            ("flat", flat, (k, n), torch.float32),
            ("seeds", seeds, (k,), torch.int32),
            ("clip_scales", clip_scales, (k,), torch.float32)):
        _build.require("ldp_noise", name, t, shape, dtype, dev)
    flat = _build.aligned(flat)
    lib = _configure(_build.load("ldp_noise"))
    out = torch.empty_like(flat)
    p = _build.ptr
    rc = lib.ldp_noise_launch(
        p(flat), p(seeds), p(clip_scales), ctypes.c_float(sigma_s), p(out),
        k, n, _build.stream(dev))
    _build.check(rc, lib, "ldp_noise_error_string")
    ldp_perturb_fleet.launches += 1
    ldp_perturb_fleet.shapes[(k, n, sigma_s)] += 1
    return out


ldp_perturb_fleet.launches = 0
ldp_perturb_fleet.shapes = collections.Counter()


def ldp_perturb_flat(flat: torch.Tensor, seed: torch.Tensor,
                     clip_scale: torch.Tensor, sigma: float,
                     clip_s: float) -> torch.Tensor:
    """One row: flat (N,); seed () int32; clip_scale () f32.  Returns
    clip_scale·flat + N(0, (σS)²) — one `ldp_perturb_fleet` launch."""
    return ldp_perturb_fleet(flat.reshape(1, -1), seed.reshape(1),
                             clip_scale.reshape(1), sigma,
                             clip_s).reshape(flat.shape)
