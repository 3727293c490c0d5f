"""Models and synthetic data of the port against the reference.

The data generators are numpy in both packages, so the shards must be
bit-identical.  Logits and gradients from carried-over params agree
within rtol 1e-5 / atol 1e-6: the convolutions and matmuls sum in a
different order in XLA and PyTorch, which moves the last float32 bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import make_federated_image_data as j_make
from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro_torch import api as tapi
from repro_torch import convert, tree
from repro_torch.data import make_federated_image_data as t_make
from repro_torch.models import cnn as tcnn
from repro_torch.models import mlp as tmlp


@pytest.mark.parametrize("kind,iid,placement", [
    ("label_flip", True, "random"), ("label_flip", False, "first"),
    ("backdoor", True, "random"), ("ddos", False, "random")])
def test_federated_shards_bit_identical(kind, iid, placement):
    kw = dict(n_train=400, n_test=50, n_cloud_test=30, hw=(8, 8),
              iid=iid, attack_kind=kind, placement=placement)
    ref = j_make(3, 10, 3, **kw)
    out = t_make(3, 10, 3, **kw)
    assert ref[3] == out[3]
    for (xa, ya), (xb, yb) in zip(ref[0], out[0]):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    for a, b in zip(ref[1] + ref[2], out[1] + out[2]):
        np.testing.assert_array_equal(a, b)


def test_materialize_matches_reference_population():
    """Data, malicious ids, profile and sampler draws are the reference's;
    the model init is the port's own (`torch.Generator`)."""
    spec = japi.ExperimentSpec(fleet=japi.FleetSpec(
        n_nodes=12, model="cnn", hw=(8, 8), samples_per_node=20,
        attack=japi.AttackMix(malicious_frac=0.25), availability=0.7))
    pj = japi.materialize(spec)
    pt = tapi.materialize(tapi.ExperimentSpec.from_json(spec.to_json()),
                          device="cpu")
    assert pj.malicious_ids == pt.malicious_ids
    np.testing.assert_array_equal(pj.profile.compute_s, pt.profile.compute_s)
    np.testing.assert_array_equal(pj.profile.bandwidth_bps,
                                  pt.profile.bandwidth_bps)
    for (xa, ya), (xb, yb) in zip(pj.node_data, pt.node_data):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    for r in range(3):
        for a, b in zip(pj.sampler.cohort(r, 12), pt.sampler.cohort(r, 12)):
            np.testing.assert_array_equal(a, b)
    assert [tuple(x.shape) for x in jax.tree.leaves(pj.params)] == \
        [tuple(x.shape) for x in tree.leaves(pt.params)]


def _close(ref, out):
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(28, 28), (14, 14), (7, 9)])
def test_cnn_logits_and_grads(hw):
    params = jcnn.init_cnn(jax.random.PRNGKey(1), in_hw=hw)
    rng = np.random.default_rng(0)
    x = rng.random((6, hw[0], hw[1], 1)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    pt = convert.to_torch(params)
    _close(jax.jit(jcnn.cnn_forward)(params, jnp.asarray(x)),
           tcnn.cnn_forward(pt, torch.tensor(x)))
    batch_j = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    batch_t = {"x": torch.tensor(x), "y": torch.tensor(y)}
    gj = jax.jit(jax.grad(lambda p: jcnn.cnn_loss(p, batch_j)[0]))(params)
    gt = torch.func.grad(lambda p: tcnn.cnn_loss(p, batch_t)[0])(pt)
    for a, b in zip(jax.tree.leaves(gj), tree.leaves(gt)):
        _close(a, b)
    assert float(jax.jit(jcnn.cnn_accuracy)(params, jnp.asarray(x),
                                            jnp.asarray(y))) \
        == float(tcnn.cnn_accuracy(pt, torch.tensor(x), torch.tensor(y)))


def test_mlp_logits_and_grads():
    params = jmlp.init_mlp(jax.random.PRNGKey(2), in_dim=64)
    rng = np.random.default_rng(1)
    x = rng.random((9, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, 9).astype(np.int32)
    pt = convert.to_torch(params)
    _close(jax.jit(jmlp.mlp_forward)(params, jnp.asarray(x)),
           tmlp.mlp_forward(pt, torch.tensor(x)))
    gj = jax.jit(jax.grad(lambda p: jmlp.mlp_loss(
        p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})[0]))(params)
    gt = torch.func.grad(lambda p: tmlp.mlp_loss(
        p, {"x": torch.tensor(x), "y": torch.tensor(y)})[0])(pt)
    for a, b in zip(jax.tree.leaves(gj), tree.leaves(gt)):
        _close(a, b)


def test_convert_round_trip_keeps_layout():
    params = jcnn.init_cnn(jax.random.PRNGKey(0), in_hw=(28, 28))
    back = convert.to_numpy(convert.to_torch(params))
    for a, b in zip(jax.tree.leaves(params), tree.leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    assert sum(x.size for x in jax.tree.leaves(params)) == 20490
