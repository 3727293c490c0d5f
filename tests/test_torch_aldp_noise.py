"""The reference backend's ALDP noise in the port against `jax.random`.

The reference draws its node-side Gaussian noise with
`jax.random.normal` (threefry, partitionable, float32).  The port draws
the same stream on the device (`prng.bits_tensor` -> uniform -> XLA's
float32 `erf_inv`), and the tolerances are:

* threefry bits and uniforms: bitwise;
* normals: bitwise.  XLA's CPU `erf_inv` is Giles' polynomial in
  contracted Horner form over XLA's own `log1p` (Cephes' rational below
  √2 − 1, Cephes' logf above) and a correctly rounded sqrt; the port
  mirrors each (`core.numerics`), so no limit is needed;
* `add_gaussian_noise` over a node axis: bitwise against the reference's
  jitted ``vmap`` (XLA folds σS into √2 and contracts the add);
* `aldp_perturb` and the reference backend's `upload_pipeline` at σ > 0:
  residuals and nnz bitwise, the noised upload within
  2e-6 · max(1, σS), the limit K1's and K5's noise already use: the clip
  norm's float32 sums run in XLA's reduction order, which PyTorch's is
  not, so the clip scale can differ by an ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.core import aldp as jaldp
from repro.fleet import stages as jstages
from repro.models import cnn as jcnn
from repro_torch import convert, prng, tree
from repro_torch import fleet as tfleet
from repro_torch.core import aldp as taldp
from repro_torch.core import numerics
from repro_torch.fleet import stages as tstages


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The draws are elementwise, so one intra-op thread computes the
    same bits; it keeps this file cheap beside the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(0, (7,)), (1, (3, 5)), (2, (2, 3, 4)), (3, (3, 3, 1, 16)),
          (4, (1000,)), (2 ** 31 + 5, (4, 257))]


def _bitwise(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.view(np.int32) == b.view(np.int32)


@pytest.mark.parametrize("seed,shape", SHAPES)
def test_bits_and_uniforms_are_bitwise_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    raw = np.asarray(key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, shape)),
        prng.random_bits(raw, shape).numpy().astype(np.uint32))
    for lo, hi in ((0.0, 1.0), (-3.0, 5.5),
                   (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)):
        want = jax.random.uniform(key, shape, jnp.float32, lo, hi)
        got = prng.uniform(raw, shape, minval=lo, maxval=hi)
        assert got.shape == shape and got.dtype == torch.float32
        assert _bitwise(want, got.numpy()).all(), (lo, hi)


@pytest.mark.parametrize("seed", [0, 17, 123456])
def test_normals_are_bitwise_jax(seed):
    """100,000 draws per key (about 340 of them in erf_inv's w >= 5
    branch): the bitwise share must be 1."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, (100_000,)))
    got = prng.normal(np.asarray(key), (100_000,)).numpy()
    share = _bitwise(want, got).mean()
    assert share == 1.0, f"bitwise share {share}"
    assert np.abs(want).max() > 2.7       # the tail branch was drawn


def test_erf_inv_and_log1p_mirror_xla():
    """The two float32 mirrors on their own, against jitted XLA, on
    uniforms plus the edges (0, tiny, near and at ±1)."""
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (50_000,),
                                      jnp.float32, -1.0, 1.0))
    edge = np.float32([0.0, -0.0, 1e-30, -1e-30, 0.5, -0.5, 0.9999999,
                       -0.9999999, 1.0, -1.0, 0.41421354, -0.41421354])
    x = np.concatenate([u, edge])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = numerics.erf_inv_f32(torch.from_numpy(x)).numpy()
    assert _bitwise(want, got).all()
    a = (x[np.abs(x) < 1] * -x[np.abs(x) < 1]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(a)))
    got = numerics.log1p_f32(torch.from_numpy(a)).numpy()
    assert _bitwise(want, got).all()


def _cnn_cohort(c, seed=0, scale=0.05):
    params = jcnn.init_cnn(jax.random.PRNGKey(seed), (14, 14))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda p: (rng.normal(size=(c,) + p.shape) * scale)
                        .astype(np.float32), params)


@pytest.mark.parametrize("sigma,clip_s", [(0.05, 1.0), (0.7, 0.5)])
def test_noise_functions_over_a_node_axis_match_the_reference_vmap(
        sigma, clip_s):
    c = 5
    deltas = _cnn_cohort(c, scale=0.3)
    keys = jax.random.split(jax.random.PRNGKey(4), c)
    jd = jax.tree.map(jnp.asarray, deltas)
    want = jax.jit(jax.vmap(lambda t, k: jaldp.add_gaussian_noise(
        t, k, sigma, clip_s)))(jd, keys)
    got = taldp.add_gaussian_noise(convert.to_torch(deltas), np.asarray(keys),
                                   sigma, clip_s)
    for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
        assert b.shape == a.shape
        assert _bitwise(a, b.numpy()).all()
    want, jn = jax.jit(jax.vmap(lambda t, k: jaldp.aldp_perturb(
        t, k, sigma, clip_s)))(jd, keys)
    got, tn = taldp.aldp_perturb(convert.to_torch(deltas), np.asarray(keys),
                                 sigma, clip_s)
    assert float(jn.min()) > clip_s          # every row is clipped
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-6 * max(1.0, sigma * clip_s))
    one, one_n = taldp.aldp_perturb(tree.map(lambda x: x[1], got),
                                    np.asarray(keys[1]), sigma, clip_s)
    assert one_n.ndim == 0                   # one node: no node axis


@pytest.mark.parametrize("ratio", [0.1, 1.0])
def test_reference_backend_upload_pipeline_with_noise(ratio):
    """`stages.upload_pipeline` on backend='reference' at σ > 0, as the
    engines compile the reference's: residuals and nnz bitwise (K1 does
    the split and the count), the noised upload within 2e-6·max(1, σS)."""
    c = 6
    deltas = _cnn_cohort(c, 2)
    res = _cnn_cohort(c, 3, 0.02)
    _, _, k2s = jfleet.chain_node_keys(jax.random.PRNGKey(3), c)
    kw = dict(sigma=0.05, sparsify_ratio=ratio, backend="reference")
    cfg = jfleet.FleetConfig(**kw)
    jd, jr, jn = jax.jit(lambda d, r, k: jstages.upload_pipeline(
        cfg, d, r, k, need_nnz=True))(jax.tree.map(jnp.asarray, deltas),
                                      jax.tree.map(jnp.asarray, res), k2s)
    td, tr, tn = tstages.upload_pipeline(
        tfleet.FleetConfig(**kw), convert.to_torch(deltas),
        convert.to_torch(res), np.asarray(k2s), need_nnz=True)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    for a, b in zip(jax.tree.leaves(jr), tree.leaves(tr)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(jd), tree.leaves(td)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-6 * max(1.0, 0.05))
        assert (b.numpy() != 0).mean() > 0.99      # the noise is dense
