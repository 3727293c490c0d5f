"""The buffered (FedBuff) fold and its detection helpers against the
reference.

`async_engine.buffered_fold` is held to the reference's
``make_window_folds(cfg)[1]`` under jit, plain, staleness-adaptive and
trust-weighted: ring, count, version, verdicts and staleness equal, the
mixed params within 1e-6 (the masked mean's float32 sum over the cohort
runs in XLA's order there; Eq. (6)'s mix is contracted there and not
here; measured: within 6e-8).  `masked_weighted_mean` with uniform weights is bitwise
`masked_mean` (the reference's contract), and `staleness_weights` is
bitwise the reference's compiled float32 power.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.core import detection as jdet
from repro.fleet.async_engine import make_window_folds
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch import fleet as tfleet
from repro_torch.core import detection as tdet
from repro_torch.fleet.async_engine import buffered_fold

C = 8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = jcnn.init_cnn(jax.random.PRNGKey(seed), (14, 14))
    omegas = jax.tree.map(
        lambda p: (np.asarray(p)[None] + rng.normal(size=(C,) + p.shape)
                   * 0.05).astype(np.float32), params)
    accs = (rng.integers(0, 65, C) / np.float32(64)).astype(np.float32)
    vdisp = rng.integers(0, 5, C).astype(np.int32)
    arrived = np.ones(C, bool)
    arrived[[2, 6]] = False
    ring = np.full(10, np.nan, np.float32)
    ring[:3] = rng.integers(0, 65, 3) / np.float32(64)
    trust = rng.uniform(0.0, 1.0, C).astype(np.float32)
    return params, omegas, accs, vdisp, arrived, ring, trust


@pytest.mark.parametrize("variant", ["plain", "staleness", "trust",
                                     "trust+staleness"])
def test_buffered_fold_matches_reference(variant):
    params, omegas, accs, vdisp, arrived, ring, trust = _inputs(
        len(variant))
    kw = dict(alpha=0.6, detect=True, detect_s=60.0, detect_warmup=3,
              staleness_adaptive="staleness" in variant,
              defense_kind=("trust_weighted" if "trust" in variant
                            else "percentile"),
              mixing="buffered")
    trust_on = "trust" in variant
    jfold = make_window_folds(jfleet.AsyncFleetConfig(**kw))[1]
    jp, jv, jring, jcount, _, jvseq, jrej, jtaus, _ = jax.jit(jfold)(
        jax.tree.map(jnp.asarray, params), jnp.int32(5), jnp.asarray(ring),
        jnp.int32(3), jax.tree.map(jnp.asarray, omegas), jnp.asarray(accs),
        jnp.asarray(vdisp), jnp.asarray(arrived),
        trust_c=jnp.asarray(trust) if trust_on else None)
    tp, ctl, p_seq = buffered_fold(
        tfleet.AsyncFleetConfig(**kw), convert.to_torch(params), 5,
        torch.from_numpy(ring.copy()), 3, convert.to_torch(omegas),
        torch.from_numpy(accs), vdisp, arrived,
        torch.from_numpy(trust) if trust_on else None)
    assert p_seq is None                 # everyone gets the post-window model
    assert ctl.version == int(jv) and ctl.count == int(jcount)
    np.testing.assert_array_equal(np.asarray(jring), ctl.ring.numpy())
    np.testing.assert_array_equal(np.asarray(jrej), ctl.rej)
    np.testing.assert_array_equal(np.asarray(jtaus), ctl.taus)
    np.testing.assert_array_equal(np.asarray(jvseq), ctl.v_seq)
    assert ctl.rej.any() and not ctl.rej.all()     # detection bit
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1], [1, 0, 1, 0, 0],
                                  [0, 0, 0, 0, 0]])
def test_masked_weighted_mean_with_uniform_weights_is_masked_mean(mask):
    rng = np.random.default_rng(len(mask) + sum(mask))
    trees = {"a": torch.from_numpy(rng.normal(size=(5, 7, 3))
                                   .astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(5, 11))
                                   .astype(np.float32))}
    m = torch.tensor(mask, dtype=torch.bool)
    want = tdet.masked_mean(trees, m)
    got = tdet.masked_weighted_mean(trees, m, torch.ones(5))
    for a, b in zip(tree.leaves(want), tree.leaves(got)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    w = torch.from_numpy(rng.uniform(0.1, 2.0, 5).astype(np.float32))
    ref = jax.jit(jdet.masked_weighted_mean)(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), trees),
        jnp.asarray(m.numpy()), jnp.asarray(w.numpy()))
    got = tdet.masked_weighted_mean(trees, m, w)
    for a, b in zip(jax.tree.leaves(ref), tree.leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("a", [0.5, 1.0, 0.3, 2.0])
def test_staleness_weights_are_bitwise(a):
    taus = np.concatenate([np.arange(-2, 2001), [65535]]).astype(np.int32)
    want = jax.jit(lambda t: jdet.staleness_weights(t, a))(jnp.asarray(taus))
    got = tdet.staleness_weights(taus, a)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(want).view(np.int32),
                                  got.numpy().view(np.int32))
