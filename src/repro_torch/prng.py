"""Host-side mirror of the JAX threefry key chain the fleet path consumes.

The JAX package draws every minibatch index and every noise seed from
`jax.random` keys: raw ``uint32[2]`` threefry keys split with
``jax_threefry_partitionable=True`` (the default of the JAX release the
reference runs on).  This module reproduces that chain bit for bit in
integer-only arithmetic — uint64 numpy arrays masked to 32 bits — so the
port and the reference train on the same batches and draw the same noise
seeds from the same spec seed.

Keys are numpy ``uint32`` arrays with a trailing axis of 2, exactly the
layout of `jax.random.key_data`.  The chain is scalar, sequential per
arrival and at most a window long, so it runs on the host: it is
bookkeeping, and its outputs (batch indices, int32 noise seeds) are moved
to the device as plain tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u(x) -> np.ndarray:
    return np.asarray(x, np.uint64) & _M32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block (20 rounds) on broadcast uint32 operands;
    returns the two output words as uint64 arrays holding uint32 values."""
    k1, k2, x1, x2 = np.broadcast_arrays(_u(k1), _u(k2), _u(x1), _u(x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: ``[0, seed mod 2^32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def key_data(keys) -> np.ndarray:
    """Raw key words (keys are stored raw, so this is the identity)."""
    return np.asarray(keys, np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split` (partitionable): key i of the split is
    threefry(key, (0, i)).  ``key`` may carry leading batch axes:
    (..., 2) -> (..., num, 2)."""
    key = np.asarray(key, np.uint32)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    b1, b2 = threefry2x32(k1, k2, 0, np.arange(num, dtype=np.uint64))
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def random_bits32(key, n: int) -> np.ndarray:
    """32-bit `random_bits` over shape (n,) (partitionable): counter i
    hashes to (b1, b2) and the draw is b1 ^ b2.  Batched like `split`."""
    key = np.asarray(key, np.uint32)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0,
                          np.arange(n, dtype=np.uint64))
    return b1 ^ b2


def randint(key, n: int, minval, maxval) -> np.ndarray:
    """`jax.random.randint(key, (n,), minval, maxval)` for int32: two
    32-bit draws combined through the span-modulus rule of
    `jax._src.random._randint`.  ``minval``/``maxval`` broadcast against
    the key's batch axes; returns int32 of shape (..., n)."""
    key = np.asarray(key, np.uint32)
    sub = split(key, 2)
    hi = random_bits32(sub[..., 0, :], n)
    lo = random_bits32(sub[..., 1, :], n)
    lo_v = np.asarray(minval, np.int64)[..., None]
    hi_v = np.asarray(maxval, np.int64)[..., None]
    span = _u(hi_v - lo_v)
    span = np.where(hi_v <= lo_v, np.uint64(1), span)
    mult = np.uint64(1 << 16) % span
    mult = (mult * mult) & _M32
    mult = mult % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (lo_v + off.astype(np.int64)).astype(np.int32)


# ---------------------------------------------------------------------------
# the fleet engines' per-node key derivations (repro.fleet.state)
# ---------------------------------------------------------------------------

def chain_node_keys(key, n: int):
    """The sequential loop's chain ``key, k1, k2 = split(key, 3)`` once per
    node.  Returns (advanced key, k1s (n, 2), k2s (n, 2))."""
    key = np.asarray(key, np.uint32)
    k1s = np.empty((n, 2), np.uint32)
    k2s = np.empty((n, 2), np.uint32)
    for i in range(n):
        key, k1s[i], k2s[i] = split(key, 3)
    return key, k1s, k2s


def parallel_node_keys(key, n: int):
    """Order-independent derivation: one split, then 2n keys from the
    subkey.  Returns (advanced key, k1s (n, 2), k2s (n, 2))."""
    key, sub = split(key, 2)
    ks = split(sub, 2 * n)
    return key, ks[:n], ks[n:]


def chain_node_keys_masked(key, mask):
    """`chain_node_keys` that advances the chain only on True slots; k1/k2
    of False slots are speculative splits the caller must not use."""
    mask = np.asarray(mask, bool)
    n = mask.shape[0]
    key = np.asarray(key, np.uint32)
    k1s = np.empty((n, 2), np.uint32)
    k2s = np.empty((n, 2), np.uint32)
    for i in range(n):
        nk, k1s[i], k2s[i] = split(key, 3)
        if mask[i]:
            key = nk
    return key, k1s, k2s


def node_noise_seeds(k2s) -> np.ndarray:
    """Node-distinct int32 noise seeds ``key_data[:, 0] ^ key_data[:, -1]``
    (wrapping uint32 -> int32), as `repro.fleet.stages` folds them."""
    raw = key_data(k2s)
    return (raw[:, 0] ^ raw[:, -1]).astype(np.int32)


def batch_indices(k1s, local_steps: int, batch_size: int, sizes
                  ) -> np.ndarray:
    """Every node's local-SGD minibatch indices, as the reference draws
    them: ``split(k1, local_steps)`` then one ``randint(k, (B,), 0, size)``
    per step.  k1s (C, 2), sizes (C,) -> int64 (C, local_steps, B)."""
    steps = split(k1s, local_steps)                        # (C, S, 2)
    sizes = np.asarray(sizes, np.int64)[:, None]           # (C, 1)
    return randint(steps, batch_size, 0, sizes).astype(np.int64)


# ---------------------------------------------------------------------------
# device-side draws: `jax.random.bits`, `uniform` and `normal` (float32)
# over tensors of counters, for the reference backend's ALDP noise
# ---------------------------------------------------------------------------

_M32_T = 0xFFFFFFFF


def threefry2x32_tensor(k1, k2, x1, x2):
    """`threefry2x32` on int64 tensors holding uint32 values (broadcast
    together); returns the two output words, int64 masked to 32 bits."""
    import torch

    k1, k2, x1, x2 = torch.broadcast_tensors(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32_T
    b = (x2 + ks[1]) & _M32_T
    for i in range(5):
        for r in _ROT[i % 2]:
            a.add_(b).bitwise_and_(_M32_T)
            b = (((b << r) & _M32_T) | (b >> (32 - r))).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(_M32_T)
        b.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32_T)
    return a, b


def bits_tensor(k1, k2, counters):
    """32-bit `random_bits` (partitionable) at flat ``counters`` under the
    keys (k1, k2): threefry(key, (hi, lo) of the counter), then b1 ^ b2.
    All int64 tensors, broadcast together; returns int64 in [0, 2^32)."""
    b1, b2 = threefry2x32_tensor(k1, k2, counters >> 32,
                                 counters & _M32_T)
    return b1.bitwise_xor_(b2)


def uniform_from_bits(bits, minval: float = 0.0, maxval: float = 1.0):
    """`jax.random.uniform` (float32) from its 32-bit draws: the top 23
    bits as the mantissa of [1, 2), minus 1, then fma(f, hi − lo, lo) and
    max(lo, ·), every constant in float32."""
    import torch
    from .core.numerics import fma_f32

    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    return torch.clamp(fma_f32(f, span, lo), min=float(lo))


def erf_inv_draws(bits):
    """erf_inv of the uniform on [nextafter(−1, 0), 1) that `normal`
    draws from its 32-bit draws (the normal before its √2)."""
    from .core.numerics import erf_inv_f32

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return erf_inv_f32(uniform_from_bits(bits, float(lo), 1.0))


def normal_scale(scale: float = 1.0) -> np.float32:
    """The constant the reference's compiled ``scale * normal(...)``
    multiplies erf_inv by: XLA folds ``scale`` into √2, f32(√2 · scale)."""
    return np.float32(np.float32(np.sqrt(2.0)) * np.float32(scale))


def normal_from_bits(bits, scale: float = 1.0):
    """`jax.random.normal` (float32) from its 32-bit draws, √2 · erf_inv(u)
    as the reference's `_normal_real` computes it; with ``scale``, the
    draws times scale as the reference's compiled programs compute
    ``scale * normal(...)``."""
    return erf_inv_draws(bits) * normal_scale(scale)


def _key_words(key, device):
    import torch

    key = np.asarray(key, np.uint32)
    return (torch.tensor(int(key[0]), dtype=torch.int64, device=device),
            torch.tensor(int(key[1]), dtype=torch.int64, device=device))


def random_bits(key, shape, device="cpu"):
    """`jax.random.bits(key, shape)` (uint32 values) as an int64 tensor."""
    import torch

    n = int(np.prod(shape, dtype=np.int64))
    k1, k2 = _key_words(key, device)
    cnt = torch.arange(n, dtype=torch.int64, device=device)
    return bits_tensor(k1, k2, cnt).reshape(tuple(shape))


def uniform(key, shape, device="cpu", minval: float = 0.0,
              maxval: float = 1.0):
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return uniform_from_bits(random_bits(key, shape, device), minval,
                             maxval)


def normal(key, shape, device="cpu"):
    """`jax.random.normal(key, shape, float32)`."""
    return normal_from_bits(random_bits(key, shape, device))
