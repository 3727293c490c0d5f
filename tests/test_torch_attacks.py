"""The adversary zoo and the trust defense in the port against the
reference.

Tolerances:
* `AttackPlan`, `make_delta_attack`, `adaptive_throttle_update`,
  `trust_update` and `trust_weights`: bitwise against the reference's
  jitted functions (XLA contracts trust's step and the uncertainty
  denominator into fmas, and the port computes those fmas exactly);
* the trust-weighted sequential fold — the port's host control scan
  (trust weight per arrival, b = w·(1 − α) or staleness_alpha·w, a =
  1 − b) then K2's plain version — against the reference's `lax.scan`:
  versions, verdicts, staleness and ring equal, params within 1e-6.
  K2 computes fma(a, cur, b·ω) and the scan (1 − b)·p + b·o under XLA's
  contraction, and the ring mean that anchors the weight is a float32
  sum in XLA's order.  Measured here: every element within 6e-8, 38-53%
  of them bitwise;
* the poisoning success rates: equal;
* DLG's gradient-match loss and its gradients within 1e-5 relative;
  `dlg_attack` after 20 Adam steps within 1e-5 (reconstruction) and
  1e-5 relative (loss history): both packages start from the same
  `jax.random.normal` dummies (`prng.normal`), and Adam's steps round
  differently (XLA contracts them);
* every scenario's `to_spec()` JSON equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.api import AttackMix as JAttackMix
from repro.core import attacks as jatk
from repro.core import detection as jdet
from repro.fleet import scenarios as jscen
from repro.fleet import stages as jstages
from repro.fleet.async_engine import make_window_folds
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch import fleet as tfleet
from repro_torch.api import AttackMix as TAttackMix
from repro_torch.core import attacks as tatk
from repro_torch.core import detection as tdet
from repro_torch.fleet import scenarios as tscen
from repro_torch.fleet import stages as tstages
from repro_torch.fleet.async_engine import sequential_fold
from repro_torch.models import cnn as tcnn

KINDS = ["label_flip", "sybil", "backdoor", "adaptive", "ddos"]


def _plans(kind, n=10, ids=(1, 4, 7)):
    kw = dict(malicious_frac=0.3, kind=kind, sybil_boost=2.5,
              adapt_poison_scale=0.4, ddos_uploads=3)
    return (jstages.AttackPlan.from_spec(JAttackMix(**kw), n, ids),
            tstages.AttackPlan.from_spec(TAttackMix(**kw), n, ids))


@pytest.mark.parametrize("kind", KINDS)
def test_attack_plan_and_delta_stage_match_reference(kind):
    jp, tp = _plans(kind)
    np.testing.assert_array_equal(jp.malicious, tp.malicious)
    for attr in ("kind", "sybil_boost", "adapt_poison_scale", "ddos_uploads",
                 "n_malicious", "needs_throttle", "flood_uploads"):
        assert getattr(jp, attr) == getattr(tp, attr), attr
    np.testing.assert_array_equal(np.asarray(jp.mask()), tp.mask().numpy())
    jstage, tstage = jstages.make_delta_attack(jp), tstages.make_delta_attack(
        tp)
    assert (jstage is None) == (tstage is None) == (
        kind not in ("sybil", "adaptive"))
    if jstage is None:
        return
    rng = np.random.default_rng(3)
    deltas = {"w": rng.normal(size=(10, 4, 3)).astype(np.float32),
              "b": rng.normal(size=(10, 5)).astype(np.float32)}
    throttle = rng.uniform(0.1, 1.0, 10).astype(np.float32)
    want = jax.jit(jstage)(jax.tree.map(jnp.asarray, deltas),
                           jnp.asarray(jp.malicious), jnp.asarray(throttle))
    got = tstage(convert.to_torch(deltas), tp.mask(),
                 torch.from_numpy(throttle))
    for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_throttle_and_trust_updates_are_bitwise():
    rng = np.random.default_rng(5)
    n = 64
    state = rng.uniform(0.0, 1.0, n).astype(np.float32)
    state[:4] = [1.0, 0.95, 0.0, 0.5]
    accepted = rng.random(n) < 0.6
    seen = rng.random(n) < 0.8
    accs = (rng.integers(0, 129, n) / np.float32(128)).astype(np.float32)
    j = lambda f, *a: np.asarray(jax.jit(f)(*map(jnp.asarray, a)))  # noqa
    t = lambda *a: [torch.from_numpy(np.asarray(x)) for x in a]     # noqa
    for scale in (0.5, 0.37):
        want = j(lambda th, r, s: jstages.adaptive_throttle_update(
            th, r, s, scale), state, ~accepted, seen)
        got = tstages.adaptive_throttle_update(*t(state, ~accepted, seen),
                                               scale)
        np.testing.assert_array_equal(want, got.numpy())
    for eta in (0.25, 0.3):
        want = j(lambda tr, a, s: jdet.trust_update(tr, a, s, eta), state,
                 accepted, seen)
        got = tdet.trust_update(*t(state, accepted, seen), eta)
        np.testing.assert_array_equal(want, got.numpy())
    for ref in (None, np.float32(0.43)):
        want = j(lambda tr, a, m: jdet.trust_weights(
            tr, a, m, 0.05, 4.0, ref=None if ref is None else
            jnp.float32(ref)), state, accs, accepted)
        got = tdet.trust_weights(*t(state, accs, accepted), 0.05, 4.0,
                                 ref=None if ref is None else
                                 torch.tensor(ref))
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("staleness", [False, True])
def test_trust_weighted_sequential_fold_on_k2(staleness):
    rng = np.random.default_rng(11 + staleness)
    c = 12
    params = jcnn.init_cnn(jax.random.PRNGKey(2), (14, 14))
    omegas = jax.tree.map(
        lambda p: (np.asarray(p)[None] + rng.normal(size=(c,) + p.shape)
                   * 0.05).astype(np.float32), params)
    accs = (rng.integers(0, 65, c) / np.float32(64)).astype(np.float32)
    vdisp = rng.integers(0, 4, c).astype(np.int32)
    arrived = rng.random(c) < 0.85
    trust = rng.uniform(0.0, 1.0, c).astype(np.float32)
    ring = np.full(6, np.nan, np.float32)
    kw = dict(alpha=0.6, detect=True, detect_s=60.0, detect_warmup=2,
              staleness_adaptive=staleness, defense_kind="trust_weighted")
    jfold = make_window_folds(jfleet.AsyncFleetConfig(**kw))[0]
    jp, jv, jring, jcount, jseq, jvseq, jrej, jtaus, _ = jax.jit(jfold)(
        jax.tree.map(jnp.asarray, params), jnp.int32(4), jnp.asarray(ring),
        jnp.int32(0), jax.tree.map(jnp.asarray, omegas), jnp.asarray(accs),
        jnp.asarray(vdisp), jnp.asarray(arrived),
        trust_c=jnp.asarray(trust))
    tp, ctl, tseq = sequential_fold(
        tfleet.AsyncFleetConfig(**kw), convert.to_torch(params), 4,
        torch.from_numpy(ring.copy()), 0, convert.to_torch(omegas),
        torch.from_numpy(accs), vdisp, arrived, torch.from_numpy(trust))
    assert (ctl.version, ctl.count) == (int(jv), int(jcount))
    np.testing.assert_array_equal(np.asarray(jring), ctl.ring.numpy())
    np.testing.assert_array_equal(np.asarray(jrej), ctl.rej)
    np.testing.assert_array_equal(np.asarray(jtaus), ctl.taus)
    np.testing.assert_array_equal(np.asarray(jvseq), ctl.v_seq)
    assert ctl.rej.any() and ctl.gates.sum() > 3
    for a, b in zip(jax.tree.leaves((jp, jseq)),
                    tree.leaves(tp) + tree.leaves(tseq)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def cnn_eval():
    params = jcnn.init_cnn(jax.random.PRNGKey(7), (14, 14))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 14, 14, 1)).astype(np.float32)
    y = rng.integers(0, 10, 200).astype(np.int32)
    return params, convert.to_torch(params), x, y


def test_success_rates_are_equal(cnn_eval):
    jp, tp, x, y = cnn_eval
    for src, dst in ((1, 7), (3, 5), (0, 0)):
        assert jatk.flip_success_rate(jcnn.cnn_forward, jp, x, y, src, dst) \
            == tatk.flip_success_rate(tcnn.cnn_forward, tp, x, y, src, dst)
    for label, size, value in ((0, 2, 1.0), (7, 3, 2.5)):
        assert jatk.backdoor_success_rate(jcnn.cnn_forward, jp, x, y, label,
                                          size, value) \
            == tatk.backdoor_success_rate(tcnn.cnn_forward, tp, x, y, label,
                                          size, value)
    assert tatk.flip_success_rate(tcnn.cnn_forward, tp, x, y, 11, 3) == 0.0


def _dlg_problem():
    w = jax.random.normal(jax.random.PRNGKey(0), (16, 4)) * 0.3

    def jloss(p, x, y):
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(x @ p) * y, -1))

    def tloss(p, x, y):
        return -torch.mean(torch.sum(torch.log_softmax(x @ p, -1) * y, -1))

    x_true = jax.random.normal(jax.random.PRNGKey(1), (1, 16)) * 0.5
    g = jax.grad(jloss)(w, x_true, jax.nn.one_hot(jnp.array([2]), 4))
    return w, g, x_true, jloss, tloss


def test_grad_match_loss_and_its_gradients():
    w, g, _, jloss, tloss = _dlg_problem()
    rng = np.random.default_rng(1)
    dx = rng.normal(size=(1, 16)).astype(np.float32) * 0.1
    dy = rng.normal(size=(1, 4)).astype(np.float32) * 0.1
    val, (gx, gy) = jax.value_and_grad(jatk._grad_match_loss,
                                       argnums=(2, 3))(
        jloss, w, jnp.asarray(dx), jnp.asarray(dy), g)
    tx = torch.from_numpy(dx).requires_grad_(True)
    ty = torch.from_numpy(dy).requires_grad_(True)
    tw = torch.from_numpy(np.array(w))
    tval = tatk._grad_match_loss(tloss, tw, tx, ty,
                                 torch.from_numpy(np.array(g)))
    tgx, tgy = torch.autograd.grad(tval, (tx, ty))
    np.testing.assert_allclose(tval.item(), float(val), rtol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5 * float(np.abs(gx).max()))
    np.testing.assert_allclose(tgy.numpy(), np.asarray(gy), rtol=1e-5,
                               atol=1e-5 * float(np.abs(gy).max()))


def test_dlg_attack_and_its_metrics():
    w, g, x_true, jloss, tloss = _dlg_problem()
    key = jax.random.PRNGKey(2)
    jx, jh = jatk.dlg_attack(jloss, w, g, (1, 16), 4, key, steps=20)
    tx, th = tatk.dlg_attack(tloss, torch.from_numpy(np.array(w)),
                             torch.from_numpy(np.array(g)), (1, 16), 4,
                             np.asarray(key), steps=20)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5)
    assert float(th[-1]) < float(th[0])
    xt = torch.from_numpy(np.array(x_true))
    np.testing.assert_allclose(
        float(tatk.reconstruction_mse(xt, tx)),
        float(jatk.reconstruction_mse(x_true, jx)), rtol=1e-5)
    rec = np.zeros((4, 8), np.float32)
    rec[0] = 1.0
    for thr in (0.05, 0.5, 2.0):
        assert float(tatk.attack_success_rate(np.zeros((4, 8)), rec, thr)) \
            == float(jatk.attack_success_rate(jnp.zeros((4, 8)),
                                              jnp.asarray(rec), thr))


@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_scenario_specs_match_reference(name):
    js, ts = jscen.get_scenario(name), tscen.get_scenario(name)
    assert ts.async_kind() == js.async_kind()
    for kind in (None, "sync", "async", "buffered"):
        for kw in ({}, {"backend": "pallas", "rounds": 3, "seed": 2},
                   {"mesh_devices": 4}):
            assert ts.to_spec(kind=kind, **kw).to_json() == \
                js.to_spec(kind=kind, **kw).to_json()
    assert ts.with_nodes(33).to_spec().to_json() == \
        js.with_nodes(33).to_spec().to_json()


def test_scenario_builders_run_and_refuse_a_mesh(tmp_path):
    """The builders run, build over a `FleetMesh` of one (a gloo group of
    one rank) and refuse anything else as a mesh."""
    import torch.distributed as dist

    eng = tscen.build_engine(tscen.get_scenario("sybil_trust"),
                             device="cpu")
    assert eng.attack.kind == "sybil" and eng.state.trust.shape == (10,)
    rec = eng.run_round()
    assert rec.n_participating == 10
    eng = tscen.build_async_engine(tscen.get_scenario("async_adaptive_trust"),
                                   device="cpu")
    assert eng.state.throttle is not None and eng.state.trust is not None
    eng.run_window()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = tfleet.FleetMesh.create()
        eng = tscen.build_engine(tscen.get_scenario("sybil_trust"),
                                 mesh=mesh, device="cpu")
        assert eng.mesh is mesh and eng.n_pad == 10
        assert eng.run_round().n_participating == 10
        eng = tscen.build_async_engine(
            tscen.get_scenario("async_adaptive_trust"), mesh=mesh,
            device="cpu")
        assert eng.run_window().n_processed > 0
    finally:
        dist.destroy_process_group()
    with pytest.raises(TypeError, match="FleetMesh"):
        tscen.build_engine(tscen.get_scenario("honest"), mesh=object(),
                           device="cpu")
