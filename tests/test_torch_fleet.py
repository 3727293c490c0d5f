"""The port's fleet engines against the reference engines, one step each.

Both packages get identical inputs — the reference's params carried over
with `convert`, the same numpy shards, nonzero starting residuals and the
same chain key — and run one synchronous round and two async windows on
each upload backend.  Alg. 2 inputs and outputs (cloud accuracies,
masks, the detection ring, versions, clocks, keys) must be equal; params
and residuals agree to atol 1e-5, since local SGD sums in another order
in XLA than in PyTorch; nnz is bitwise at stage level."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import fleet as jfleet
from repro.data import make_federated_image_data
from repro.fleet import stages as jstages
from repro.models import mlp as jmlp
from repro_torch import convert, tree
from repro_torch import fleet as tfleet
from repro_torch.fleet import stages as tstages
from repro_torch.models import mlp as tmlp

N_NODES = 6


def _setup(seed=0):
    node_data, test, cloud, _ = make_federated_image_data(
        seed, N_NODES, 2, n_train=N_NODES * 30, n_test=64, n_cloud_test=48,
        hw=(8, 8), placement="random")
    params = jmlp.init_mlp(jax.random.PRNGKey(seed), 64)
    profile = jfleet.NodeProfile.lognormal(N_NODES, 1.0, 0.5, 12.5e6,
                                           seed=seed)
    rng = np.random.default_rng(seed)
    residuals = jax.tree.map(
        lambda x: (rng.normal(size=(N_NODES,) + x.shape) * 0.05)
        .astype(np.float32), params)
    return node_data, test, cloud, params, profile, residuals


def _cfg(mod_cfg, backend, **kw):
    sigma = 0.3 if backend == "pallas" else 0.0
    return mod_cfg(local_steps=3, batch_size=8, lr=0.1, sigma=sigma,
                   sparsify_ratio=0.3, detect=True, detect_s=60.0,
                   key_mode="sequential", backend=backend, seed=0, **kw)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                               rtol=0, atol=atol)


def _tree_close(ref, out, atol=1e-5):
    for a, b in zip(jax.tree.leaves(ref), tree.leaves(out)):
        _close(a, b, atol)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_sync_round_matches_reference_engine(backend):
    node_data, test, cloud, params, profile, residuals = _setup()
    key = jax.random.PRNGKey(7)
    jeng = jfleet.FleetEngine(params, jmlp.mlp_loss, jmlp.mlp_accuracy,
                              node_data, test, cloud,
                              _cfg(jfleet.FleetConfig, backend),
                              profile=profile)
    jeng.load_state(jax.tree.map(jnp.asarray, residuals), key)
    teng = tfleet.FleetEngine(convert.to_torch(params), tmlp.mlp_loss,
                              tmlp.mlp_accuracy, node_data, test, cloud,
                              _cfg(tfleet.FleetConfig, backend),
                              profile=profile, device="cpu")
    teng.load_state(convert.to_torch(residuals), np.asarray(key))
    idx = np.arange(N_NODES)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)     # one padded slot
    jp, jres, jkey, _, _, jm = jeng._round_fn(
        jeng.params, jeng.state.residuals, jeng.state.chain_key, None, None,
        jeng.data.x, jeng.data.y, jeng.data.sizes,
        jnp.asarray(idx, jnp.int32), jnp.asarray(valid))
    tp, tres, tkey, tm = teng._round_fn(teng.params, teng.state.residuals,
                                        teng.state.chain_key, idx, valid)
    np.testing.assert_array_equal(np.asarray(jkey), tkey)
    np.testing.assert_array_equal(np.asarray(jm["accs"]),
                                  tm["accs"].numpy())
    np.testing.assert_array_equal(np.asarray(jm["mask"]),
                                  tm["mask"].numpy())
    assert float(jm["thr"]) == float(tm["thr"])
    _tree_close(jres, tres)
    _tree_close(jp, tp)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_upload_pipeline_stage_nnz_and_residuals(backend):
    """Stage level, as the engines compile it (the reference stage under
    jit): sparse set, residuals and nnz bitwise; the noised upload within
    2e-6 · max(1, σS)."""
    _, _, _, params, _, residuals = _setup(1)
    rng = np.random.default_rng(2)
    deltas = jax.tree.map(lambda r: rng.normal(size=r.shape)
                          .astype(np.float32) * 0.1, residuals)
    cfg = _cfg(jfleet.FleetConfig, backend)
    _, _, k2s = jfleet.chain_node_keys(jax.random.PRNGKey(3), N_NODES)
    jd, jr, jn = jax.jit(lambda d, r, k: jstages.upload_pipeline(
        cfg, d, r, k, need_nnz=True))(jax.tree.map(jnp.asarray, deltas),
                                      jax.tree.map(jnp.asarray, residuals),
                                      k2s)
    td, tr, tn = tstages.upload_pipeline(
        _cfg(tfleet.FleetConfig, backend), convert.to_torch(deltas),
        convert.to_torch(residuals), np.asarray(k2s), need_nnz=True)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    for a, b in zip(jax.tree.leaves(jr), tree.leaves(tr)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _tree_close(jd, td, atol=2e-6 * max(1.0, cfg.sigma * cfg.clip_s))


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_async_windows_match_reference_engine(backend):
    node_data, test, cloud, params, profile, residuals = _setup(2)
    key = jax.random.PRNGKey(9)
    kw = dict(window=0.8, detect_warmup=2, detect_window=6)
    jeng = jfleet.AsyncFleetEngine(
        params, jmlp.mlp_loss, jmlp.mlp_accuracy, node_data, test, cloud,
        _cfg(jfleet.AsyncFleetConfig, backend, **kw), profile=profile)
    jeng.load_state(jax.tree.map(jnp.asarray, residuals), key)
    teng = tfleet.AsyncFleetEngine(
        convert.to_torch(params), tmlp.mlp_loss, tmlp.mlp_accuracy,
        node_data, test, cloud, _cfg(tfleet.AsyncFleetConfig, backend, **kw),
        profile=profile, device="cpu")
    teng.load_state(convert.to_torch(residuals), np.asarray(key))
    for _ in range(2):
        jr, tr = jeng.run_window(), teng.run_window()
        assert dataclasses.asdict(jr) | {"accuracy": 0} == \
            dataclasses.asdict(tr) | {"accuracy": 0}
        assert abs(jr.accuracy - tr.accuracy) <= 1.0 / 64
        js, ts = jeng.state, teng.state
        np.testing.assert_array_equal(np.asarray(js.chain_key), ts.chain_key)
        np.testing.assert_array_equal(np.asarray(js.acc_ring),
                                      ts.acc_ring.numpy())
        assert int(js.acc_count) == ts.acc_count
        assert int(js.version) == ts.version
        np.testing.assert_array_equal(np.asarray(js.next_arrival),
                                      ts.next_arrival.numpy())
        np.testing.assert_array_equal(np.asarray(js.dispatched_version),
                                      ts.dispatched_version.numpy())
        _tree_close(js.dispatched, ts.dispatched)
        _tree_close(js.residuals, ts.residuals)
        _tree_close(jeng.params, teng.params)
    assert jr.n_processed > 1       # the fold ran over several arrivals
