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
import torch

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


def _two_leaf_cohort(seed, c=5):
    rng = np.random.default_rng(seed)
    tree_ = {"w": rng.normal(size=(c, 37, 29)).astype(np.float32) * 0.1,
             "b": rng.normal(size=(c, 53)).astype(np.float32) * 0.1}
    res = {k: rng.normal(size=v.shape).astype(np.float32) * 0.05
           for k, v in tree_.items()}
    tree_["b"][c - 1, :4] = 0.0        # exact zeros before the split
    return tree_, res


def test_unfused_chain_stages_match_reference():
    """`sparsify_pallas_cohort` (K4) -> `count_upload_nnz` (K3) ->
    `aldp_pallas_cohort` (K5) on a two-leaf tree, against the reference's
    stages: the split bitwise (int32 views), nnz equal on both backends,
    the noised upload within K5's 2e-6 · max(1, σS)."""
    deltas, res = _two_leaf_cohort(3)
    _, _, k2s = jfleet.chain_node_keys(jax.random.PRNGKey(4), 5)
    jd = jax.tree.map(jnp.asarray, deltas)
    ju, jr = jax.jit(lambda d, r: jstages.sparsify_pallas_cohort(
        d, r, 0.2))(jd, jax.tree.map(jnp.asarray, res))
    tu, trs = tstages.sparsify_pallas_cohort(convert.to_torch(deltas),
                                             convert.to_torch(res), 0.2)
    for a, b in zip(jax.tree.leaves((ju, jr)), tree.leaves(tu)
                    + tree.leaves(trs)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
    for backend in ("reference", "pallas"):
        np.testing.assert_array_equal(
            np.asarray(jstages.count_upload_nnz(ju, backend)),
            tstages.count_upload_nnz(tu, backend).numpy())
    sigma, clip_s = 0.6, 1.0
    jn = jax.jit(lambda d: jstages.aldp_pallas_cohort(d, k2s, sigma,
                                                      clip_s))(ju)
    tn = tstages.aldp_pallas_cohort(tu, np.asarray(k2s), sigma, clip_s)
    _tree_close(jn, tn, atol=2e-6 * max(1.0, sigma * clip_s))
    flat, unflatten = tstages.flatten_cohort(tu)
    assert flat.shape == (5, 37 * 29 + 53)
    for a, b in zip(tree.leaves(unflatten(flat)), tree.leaves(tu)):
        assert torch.equal(a, b)


def test_tree_wrappers_match_reference_ops():
    """`kernels.ops`: the per-leaf flat K4/K5 wrappers over a parameter
    tree (one threshold for the tree; leaf i seeded seed + i·7919)."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    deltas, res = _two_leaf_cohort(5, c=1)
    g = {k: v[0] for k, v in deltas.items()}
    r = {k: v[0] for k, v in res.items()}
    ju, jr = jops.sparsify_pallas(jax.tree.map(jnp.asarray, g),
                                  jax.tree.map(jnp.asarray, r), ratio=0.3)
    tu, trs = tops.sparsify_pallas(convert.to_torch(g), convert.to_torch(r),
                                   ratio=0.3)
    for a, b in zip(jax.tree.leaves((ju, jr)), tree.leaves(tu)
                    + tree.leaves(trs)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
    sigma, clip_s = 0.4, 0.5
    seed = np.int32(2 ** 31 - 3000)     # leaf 1's seed wraps past 2^31
    jp, jnrm = jops.aldp_perturb_pallas(jax.tree.map(jnp.asarray, g),
                                        jnp.asarray(seed), sigma=sigma,
                                        clip_s=clip_s)
    tp, tnrm = tops.aldp_perturb_pallas(convert.to_torch(g),
                                        torch.tensor(seed), sigma=sigma,
                                        clip_s=clip_s)
    np.testing.assert_allclose(float(tnrm), float(jnrm), rtol=1e-6)
    _tree_close(jp, tp, atol=2e-6 * max(1.0, sigma * clip_s))
