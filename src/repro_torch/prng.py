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
