"""The port's sequential reference loops (`Topology(kind="sequential")`)
against the JAX package's loops and against the port's fleet engines.

Both packages run the same spec over one population: the reference's MLP
params carried over with `convert`, the same numpy shards (8 nodes, 8x8
images, 2 label-flip attackers) and the same node profile.  The four
schemes (sfl, afl, sldpfl, aldpfl), DGC at 0.25 and staleness-adaptive
mixing run in both loops:

* port loop against JAX loop: versions, rejections and bytes equal, t
  within rtol 1e-9 (sync) or 1e-5 (async), accuracy within 2e-3, final
  params within 1e-5 (local SGD sums in another order in PyTorch than in
  XLA), the key chain equal, epsilon and kappa approximately equal;
* port loop against the port's fleet engine at the limits
  `tests/test_fleet.py` and `tests/test_async_fleet.py` hold the JAX
  engines to their loop at.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import accumulator as jacc
from repro.data import make_federated_image_data
from repro.fleet import NodeProfile as JProfile
from repro.models import mlp as jmlp
from repro_torch import api as tapi
from repro_torch import convert, tree
from repro_torch.core import accumulator as tacc
from repro_torch.fleet import NodeProfile as TProfile
from repro_torch.fleet import stages as tstages
from repro_torch.models import mlp as tmlp

N_NODES = 8
# scheme -> (schedule kind, sigma, sparsify ratio, staleness-adaptive)
SCHEMES = {
    "sfl": ("sync", 0.0, 1.0, False),
    "sldpfl": ("sync", 0.05, 1.0, False),
    "sldpfl-dgc": ("sync", 0.05, 0.25, False),
    "afl": ("async", 0.0, 1.0, False),
    "aldpfl": ("async", 0.05, 1.0, False),
    "aldpfl-dgc": ("async", 0.05, 0.25, False),
    "afl-stale": ("async", 0.0, 1.0, True),
}


def _spec(m, scheme, topology):
    kind, sigma, ratio, stale = SCHEMES[scheme]
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=N_NODES),
        schedule=m.SchedulePolicy(kind=kind, staleness_adaptive=stale),
        privacy=m.PrivacySpec(sigma=sigma),
        compression=m.CompressionSpec(sparsify_ratio=ratio),
        defense=m.DefenseSpec(detect=True),
        topology=m.Topology(kind=topology),
        train=m.TrainSpec(local_steps=8, batch_size=16, lr=0.1),
        rounds=5 if kind == "sync" else 4, seed=0)


@functools.lru_cache(maxsize=None)
def _inputs():
    node_data, test, cloud, _ = make_federated_image_data(
        0, n_nodes=N_NODES, n_malicious=2, n_train=640, n_test=256,
        n_cloud_test=128, hw=(8, 8))
    params = jmlp.init_mlp(jax.random.PRNGKey(0), 64)
    profile = JProfile.lognormal(N_NODES, 1.0, 0.5, 12.5e6, seed=0)
    return node_data, test, cloud, params, profile


def _population(m):
    node_data, test, cloud, params, profile = _inputs()
    if m is japi:
        return japi.Population(
            params=params, loss_fn=jmlp.mlp_loss, acc_fn=jmlp.mlp_accuracy,
            node_data=node_data, test_data=test, cloud_test=cloud,
            profile=profile)
    return tapi.Population(
        params=convert.to_torch(params), loss_fn=tmlp.mlp_loss,
        acc_fn=tmlp.mlp_accuracy, node_data=node_data, test_data=test,
        cloud_test=cloud,
        profile=TProfile(compute_s=profile.compute_s,
                         bandwidth_bps=profile.bandwidth_bps))


def _execute(m, scheme, topology):
    """(report, final RunState) of one run through `execute`."""
    plan = m.compile_plan(_spec(m, scheme, topology))
    pop = _population(m)
    if m is japi:
        state = japi.init_state(plan, pop)
        japi.execute(plan, pop, state)
    else:
        state = tapi.init_state(plan, pop, device="cpu")
        tapi.execute(plan, pop, state, device="cpu")
    comm = sum(r.comm_time for r in state.history)
    comp = sum(r.comp_time for r in state.history)
    eps = (state.accountant.epsilon(plan.spec.privacy.delta)
           if state.accountant is not None else 0.0)
    return m.RunReport(
        mode=plan.mode, engine=plan.engine, records=list(state.history),
        kappa=comm / (comm + comp), epsilon_spent=eps,
        final_accuracy=state.history[-1].accuracy,
        final_params=state.params), state


@functools.lru_cache(maxsize=None)
def _run(package, scheme, topology):
    return _execute(japi if package == "jax" else tapi, scheme, topology)


def _leaves(params):
    if isinstance(tree.leaves(params)[0], torch.Tensor):
        return [x.numpy() for x in tree.leaves(params)]
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _held(ref, out, scheme):
    """The JAX tests' fleet-versus-loop limits between two reports."""
    t_rtol = 1e-9 if SCHEMES[scheme][0] == "sync" else 1e-5
    hr, ho = ref.records, out.records
    assert len(hr) == len(ho)
    assert [r.version for r in hr] == [r.version for r in ho]
    assert [r.n_rejected for r in hr] == [r.n_rejected for r in ho]
    assert [r.comm_bytes for r in hr] == [r.comm_bytes for r in ho]
    np.testing.assert_allclose([r.t for r in ho], [r.t for r in hr],
                               rtol=t_rtol)
    np.testing.assert_allclose([r.accuracy for r in ho],
                               [r.accuracy for r in hr], atol=2e-3)
    for a, b in zip(_leaves(ref.final_params), _leaves(out.final_params)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert out.epsilon_spent == pytest.approx(ref.epsilon_spent)
    assert out.kappa == pytest.approx(ref.kappa)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_port_loop_matches_jax_loop(scheme):
    ref, jstate = _run("jax", scheme, "sequential")
    out, tstate = _run("torch", scheme, "sequential")
    assert out.engine == ref.engine == "sequential"
    _held(ref, out, scheme)
    np.testing.assert_array_equal(np.asarray(jstate.key), tstate.key)
    if SCHEMES[scheme][2] < 1.0:
        jres = np.stack([np.concatenate([np.asarray(x).reshape(-1) for x
                                         in jax.tree.leaves(r)])
                         for r in jstate.residuals])
        tres = torch.cat([x.reshape(N_NODES, -1)
                          for x in tree.leaves(tstate.residuals)], 1)
        np.testing.assert_allclose(tres.numpy(), jres, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_port_loop_matches_port_fleet_engine(scheme):
    out, tstate = _run("torch", scheme, "sequential")
    eng, estate = _execute(tapi, scheme, "single")
    assert eng.engine == "fleet"
    _held(out, eng, scheme)
    np.testing.assert_array_equal(estate.key, tstate.key)


def _row(r):
    return (r.t, r.version, r.accuracy, r.comm_bytes, r.comp_time,
            r.comm_time, r.n_rejected, r.bytes_source)


def test_run_reports_the_sequential_engine():
    """`api.run` routes a sequential plan to the loop: the report names
    it, and its records and params are `execute`'s bit for bit."""
    rep = tapi.run(tapi.compile_plan(_spec(tapi, "aldpfl-dgc",
                                           "sequential")),
                   population=_population(tapi), device="cpu")
    out, _ = _run("torch", "aldpfl-dgc", "sequential")
    assert rep.engine == "sequential" and rep.mode == "async"
    assert [_row(r) for r in rep.records] == [_row(r) for r in out.records]
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(rep.final_params),
                   tree.leaves(out.final_params)))


def test_loop_calls_no_kernel_wrapper(monkeypatch):
    """The reference loops run no Pallas kernel, so the port's loops call
    none of K1-K8's wrappers (on the card they would launch)."""
    from repro_torch.kernels import (flash_attention, ldp_noise,
                                     selective_scan, sparsify, ssd_scan,
                                     upload_fused, window_fold, wire_bytes)
    for mod, name in ((upload_fused, "upload_fused_fleet"),
                      (window_fold, "window_fold_fleet"),
                      (wire_bytes, "nnz_fleet"),
                      (sparsify, "sparsify_fleet"),
                      (ldp_noise, "ldp_perturb_fleet"),
                      (flash_attention, "flash_attention"),
                      (selective_scan, "selective_scan"),
                      (ssd_scan, "ssd_scan")):
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"the sequential loop called {_name}")
        monkeypatch.setattr(mod, name, refuse)
    for scheme in ("sldpfl-dgc", "aldpfl-dgc"):
        spec = dataclasses.replace(_spec(tapi, scheme, "sequential"),
                                   rounds=1)
        rep = tapi.run(tapi.compile_plan(spec), population=_population(tapi),
                       device="cpu")
        assert len(rep.records) == 1


@pytest.mark.parametrize("ratio", [1.0, 0.25, 0.1])
def test_upload_bytes_pinned_to_bytes_per_node(ratio):
    """The loop's per-upload bytes and the engines' per-node bytes are one
    formula, and both equal the reference's."""
    params = _inputs()[3]
    n = sum(x.size for x in jax.tree.leaves(params))
    tparams = convert.to_torch(params)
    assert tacc.upload_bytes(tparams, ratio) == \
        tstages.bytes_per_node(n, ratio) == jacc.upload_bytes(params, ratio)
