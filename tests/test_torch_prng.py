"""The port's threefry mirror (`repro_torch.prng`) against `jax.random`.

Every key, split, batch index and noise seed the fleet path consumes must
be bit-equal to the reference's (jax runs with
``jax_threefry_partitionable=True``), so both packages train on the same
minibatches and draw the same noise streams."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.fleet import state as jstate
from repro.fleet.stages import node_noise_seeds as j_node_noise_seeds
from repro_torch import prng

SEEDS = (0, 1, 42, 12345, -3, 2 ** 31 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split_bitwise(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k), prng.PRNGKey(seed))
    for n in (1, 2, 3, 7, 64):
        np.testing.assert_array_equal(np.asarray(jax.random.split(k, n)),
                                      prng.split(prng.PRNGKey(seed), n))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,maxval", [(16, 60), (5, 1), (33, 1000),
                                      (8, 2 ** 31 - 1), (4, 7), (3, 0)])
def test_randint_bitwise(seed, n, maxval):
    a = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                      maxval))
    b = prng.randint(prng.PRNGKey(seed), n, 0, maxval)
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.int32


@pytest.mark.parametrize("seed", (0, 3, 99))
def test_chain_functions_bitwise(seed):
    k = jax.random.PRNGKey(seed)
    pk = prng.PRNGKey(seed)
    for ref, port in ((jstate.chain_node_keys(k, 9),
                       prng.chain_node_keys(pk, 9)),
                      (jstate.parallel_node_keys(k, 9),
                       prng.parallel_node_keys(pk, 9))):
        for a, b in zip(ref, port):
            np.testing.assert_array_equal(np.asarray(a), b)
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    ref = jstate.chain_node_keys_masked(k, jnp.asarray(mask))
    port = prng.chain_node_keys_masked(pk, mask)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(j_node_noise_seeds(ref[2])),
                                  prng.node_noise_seeds(port[2]))


def test_batch_indices_match_reference_local_train_draws():
    """`batch_indices` = split(k1, steps) then randint(k, (B,), 0, size)
    per step — the draws inside `fleet.stages.make_local_train`."""
    _, k1s, _ = prng.chain_node_keys(prng.PRNGKey(5), 6)
    sizes = np.array([60, 13, 60, 5, 1, 2], np.int32)
    idx = prng.batch_indices(k1s, 4, 16, sizes)
    assert idx.shape == (6, 4, 16)
    for c in range(6):
        keys = jax.random.split(jnp.asarray(k1s[c]), 4)
        for s in range(4):
            ref = jax.random.randint(keys[s], (16,), 0, jnp.int32(sizes[c]))
            np.testing.assert_array_equal(np.asarray(ref), idx[c, s])
