"""The noise header's per-row keys against the reference kernel's hash.

`csrc/ldp_hash.cuh`, which K1 and K5 share, no longer forms the murmur
input of flat position p as the TPU kernel does, e + u32(seed +
b·7919)·2654435761 + s·0x9E3779B9 with b = p >> 18 and e = p mod 2^18.
It adds p + b·kTileStep to a key made once per row, u32(seed)·2654435761 +
s·0x9E3779B9, where kTileStep = 7919·2654435761 − 2^18 (mod 2^32).  The
CUDA code cannot run here, so these tests hold a numpy copy of that form
(`keyed_uniform`, the header's operations in uint32) bitwise against the
reference's `_hash_uniform`, tile by tile, across tile boundaries and at
the int32 seed extremes, and against the port's plain `block_noise`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ldp_noise as jldp
from repro_torch.kernels import ldp_noise as ldp

SEED_MUL = 2654435761
STREAM_MUL = 0x9E3779B9
TILE_SHIFT = 18
TILE_STEP = (7919 * SEED_MUL - (1 << TILE_SHIFT)) & 0xFFFFFFFF


def keyed_uniform(seed: int, stream: int, p: np.ndarray) -> np.ndarray:
    """`ldp_noise_add`'s uniform of stream ``stream`` at positions ``p`` of
    a row seeded ``seed``, as the header computes it (uint32 wraps)."""
    key = np.uint32((((seed & 0xFFFFFFFF) * SEED_MUL)
                     + stream * STREAM_MUL) & 0xFFFFFFFF)
    p = p.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = p + (p >> np.uint32(TILE_SHIFT)) * np.uint32(TILE_STEP) + key
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return (x >> np.uint32(8)).astype(np.float32) / np.float32(1 << 24)


@pytest.mark.parametrize("seed", [0, 5, -1, 2**31 - 1, -2**31])
@pytest.mark.parametrize("stream", [1, 2])
def test_row_keys_give_the_reference_hash_bitwise(seed, stream):
    """Three tiles of a row: every position's uniform equals the reference
    kernel's, which hashes in-tile index e under the tile's own seed."""
    tile = 1 << TILE_SHIFT
    for b in range(3):
        blk_seed = jnp.int32(np.int32(np.uint32((seed + b * 7919)
                                                & 0xFFFFFFFF)))
        want = np.asarray(jldp._hash_uniform(blk_seed, stream, (256, 1024)))
        got = keyed_uniform(seed, stream, b * tile + np.arange(tile))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.reshape(-1).view(np.int32))


@pytest.mark.parametrize("seed", [7, -2**31])
def test_row_keys_give_the_plain_noise_bitwise(seed):
    """Box–Muller on the keyed uniforms, with the plain version's own
    operations, equals `block_noise` bit for bit past the first tile."""
    n = (1 << TILE_SHIFT) + 5000
    p = np.arange(n)
    u1 = torch.clamp(torch.from_numpy(keyed_uniform(seed, 1, p)), min=1e-12)
    u2 = torch.from_numpy(keyed_uniform(seed, 2, p))
    sigma_s = 0.7
    got = sigma_s * torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * np.pi) * u2)
    want = ldp.block_noise(torch.tensor([seed], dtype=torch.int32), n,
                           sigma_s)[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
