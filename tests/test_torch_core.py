"""Core mechanisms of the port against `repro.core`.

Tolerances: the DGC threshold, keep set and residuals are bitwise (the
port mirrors `jnp.quantile`'s compiled float32 arithmetic); Alg. 2
verdicts and thresholds are identical (bitwise percentiles); `mix` /
`mix_stale` are bitwise against eager JAX except `staleness_alpha`'s
power, which may differ by 1 ulp between XLA's and PyTorch's `pow`; the
accountant is numpy in both packages and agrees to 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accumulator as jacc
from repro.core import aldp as jaldp
from repro.core import async_update as jasync
from repro.core import detection as jdet
from repro.core.accountant import MomentsAccountant as JAccountant
from repro.fleet.stages import detect_masked as j_detect_masked
from repro_torch import tree
from repro_torch.core import accumulator as tacc
from repro_torch.core import aldp as taldp
from repro_torch.core import async_update as tasync
from repro_torch.core import detection as tdet
from repro_torch.core.accountant import MomentsAccountant as TAccountant
from repro_torch.fleet.stages import detect_masked as t_detect_masked


def _rows(rng, k, n, ties):
    x = rng.normal(size=(k, n)).astype(np.float32)
    if ties:        # coarse grid: many equal magnitudes around the cutoff
        x = (np.round(x * 4) / 4).astype(np.float32)
    return x


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.01, 0.25])
@pytest.mark.parametrize("n,ties", [(96, False), (1301, False), (4608, True),
                                    (700, True), (10, False)])
def test_leaf_threshold_bitwise(ratio, n, ties):
    """Against the threshold as the engines compile it (jit of a vmap,
    the quantile fraction a constant)."""
    x = _rows(np.random.default_rng(n), 5, n, ties)
    ref = jax.jit(jax.vmap(lambda v: jacc.leaf_threshold(v, ratio)))(
        jnp.asarray(x))
    out = tacc.leaf_threshold(torch.tensor(x), ratio)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("ratio", [0.1, 0.3])
@pytest.mark.parametrize("ties", [False, True])
def test_dgc_split_and_residual_bitwise(ratio, ties):
    rng = np.random.default_rng(7)
    shapes = {"a": {"w": (3, 3, 1, 16), "b": (16,)}, "c": {"w": (40, 10)}}
    mk = lambda: tree.map(lambda s: _rows(rng, 4, int(np.prod(s)), ties)
                          .reshape((4,) + s), shapes)
    grad, res = mk(), mk()
    j_up, j_res, _ = jax.jit(jax.vmap(
        lambda r, g: jacc.accumulate_and_sparsify(r, g, ratio)))(
        jax.tree.map(jnp.asarray, res), jax.tree.map(jnp.asarray, grad))
    t_up, t_res, _ = tacc.accumulate_and_sparsify(
        tree.map(torch.tensor, res), tree.map(torch.tensor, grad), ratio,
        node_axis=True)
    for a, b in zip(jax.tree.leaves(j_up) + jax.tree.leaves(j_res),
                    tree.leaves(t_up) + tree.leaves(t_res)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _cohorts(n_cohorts, seed=0, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 201, int(rng.integers(lo, hi))) / 200)
            .astype(np.float32) for _ in range(n_cohorts)]


def test_detection_threshold_identical_verdicts():
    """`detection.detection_threshold` as the reference's sequential loop
    calls it (eagerly) over 1000 cohorts on a 1/200 grid at s=80.  Cohort
    sizes come from a short list: each new size costs the reference one
    compile."""
    rng = np.random.default_rng(2)
    for _ in range(1000):
        n = int(rng.choice([5, 8, 10, 13, 20, 27, 33, 40]))
        a = (rng.integers(0, 201, n) / 200).astype(np.float32)
        ref = float(jdet.detection_threshold(jnp.asarray(a), 80.0))
        out = tdet.detection_threshold(torch.tensor(a), 80.0)
        assert float(out) == ref
        np.testing.assert_array_equal(a > ref, (torch.tensor(a) > out)
                                      .numpy())


def test_ring_threshold_and_detect_masked_identical_verdicts():
    """The ring (async) and masked-cohort (sync) thresholds as the engines
    compile them: NaN-masked percentiles over 1000 cohorts."""
    w = 40
    cohorts = _cohorts(1000, seed=1, hi=w + 1)
    rings = np.full((len(cohorts), w), np.nan, np.float32)
    accs = np.zeros((len(cohorts), w), np.float32)
    valid = np.zeros((len(cohorts), w), bool)
    counts = np.array([len(a) for a in cohorts], np.int32)
    for i, a in enumerate(cohorts):
        rings[i, :len(a)] = a
        accs[i, :len(a)] = a
        valid[i, :len(a)] = True
    j_ring = np.asarray(jax.jit(jax.vmap(
        lambda r, c: jdet.ring_threshold(r, c, 80.0)))(
        jnp.asarray(rings), jnp.asarray(counts)))
    j_mask, j_thr = jax.jit(jax.vmap(
        lambda a, v: j_detect_masked(a, v, 80.0)))(
        jnp.asarray(accs), jnp.asarray(valid))
    for i, a in enumerate(cohorts):
        ring = torch.tensor(rings[i])
        thr = tdet.ring_threshold(ring, int(counts[i]), 80.0)
        assert float(thr) == float(j_ring[i])
        assert tdet.ring_detect(ring, int(counts[i]), torch.tensor(a[0]),
                                80.0, 4) == bool(counts[i] >= 4
                                                 and a[0] <= j_ring[i])
        mask, thr = t_detect_masked(torch.tensor(accs[i]),
                                    torch.tensor(valid[i]), 80.0)
        assert float(thr) == float(j_thr[i])
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask[i]))


def test_masked_mean_and_fallback():
    rng = np.random.default_rng(3)
    x = {"w": rng.normal(size=(6, 5, 4)).astype(np.float32)}
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    ref = jdet.masked_mean({"w": jnp.asarray(x["w"])}, jnp.asarray(mask))
    out = tdet.masked_mean({"w": torch.tensor(x["w"])}, torch.tensor(mask))
    # summation order differs between XLA and PyTorch: a few ulps
    np.testing.assert_allclose(np.asarray(ref["w"]), out["w"].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert tdet.detect_fell_back([0.5, 0.5], 0.5)
    assert not tdet.detect_fell_back([0.5, 0.7], 0.5)
    assert tdet.default_window(2) == jdet.default_window(2) == 4


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.9])
def test_mix_and_mix_stale(alpha):
    """`mix` is bitwise.  `staleness_alpha` is bitwise XLA's compiled
    weight for every integer τ in 0..19,999 and every exponent a tested
    (a = 1 is the pow(x, −1) -> 1/x rewrite); `mix_stale` is bitwise."""
    rng = np.random.default_rng(4)
    g = rng.normal(size=(300,)).astype(np.float32)
    n = rng.normal(size=(300,)).astype(np.float32)
    ref = jasync.mix({"w": jnp.asarray(g)}, {"w": jnp.asarray(n)}, alpha)
    out = tasync.mix({"w": torch.tensor(g)}, {"w": torch.tensor(n)}, alpha)
    np.testing.assert_array_equal(np.asarray(ref["w"]), out["w"].numpy())
    taus = np.arange(20000)
    for a in (0.5, 0.3, 0.75, 1.0):
        wj = np.asarray(jax.jit(lambda t, a=a: jasync.staleness_alpha(
            alpha, t, a))(jnp.asarray(taus, jnp.int32)))
        wt = np.array([tasync.staleness_alpha(alpha, int(t), a).numpy()
                       for t in taus], np.float32)
        np.testing.assert_array_equal(wt.view(np.int32), wj.view(np.int32))
    for tau in range(0, 200):
        ref = jasync.mix_stale({"w": jnp.asarray(g)}, {"w": jnp.asarray(n)},
                               alpha, tau)
        out = tasync.mix_stale({"w": torch.tensor(g)},
                               {"w": torch.tensor(n)}, alpha, tau)
        np.testing.assert_array_equal(np.asarray(ref["w"]),
                                      out["w"].numpy())
    assert tasync.communication_efficiency(1.0, 3.0) == \
        jasync.communication_efficiency(1.0, 3.0)


def test_aldp_clip_and_calibration():
    rng = np.random.default_rng(5)
    t = {"a": rng.normal(size=(50,)).astype(np.float32) * 3,
         "b": rng.normal(size=(7, 3)).astype(np.float32)}
    jc, jn = jaldp.clip_by_global_norm(jax.tree.map(jnp.asarray, t), 1.0)
    tc, tn = taldp.clip_by_global_norm(tree.map(torch.tensor, t), 1.0)
    np.testing.assert_allclose(float(jn), float(tn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    for eps, delta in ((8.0, 1e-3), (1.0, 1e-5)):
        assert taldp.sigma_for_epsilon(eps, delta) == \
            jaldp.sigma_for_epsilon(eps, delta)
        assert taldp.epsilon_for_sigma(0.7, delta) == \
            jaldp.epsilon_for_sigma(0.7, delta)


@pytest.mark.parametrize("sigma,q,steps", [(0.5, 1.0, 16), (1.1, 0.1, 40),
                                           (4.0, 0.5, 3)])
def test_accountant_epsilon(sigma, q, steps):
    ja, ta = JAccountant(sigma, q), TAccountant(sigma, q)
    ja.step(steps)
    ta.step(steps)
    assert abs(ja.epsilon(1e-3) - ta.epsilon(1e-3)) <= 1e-12
    assert abs(ja.delta(8.0) - ta.delta(8.0)) <= 1e-12
