"""The MoE FFN (`repro_torch.models.moe`) against `repro.models.moe`.

The reference's params (`init_moe`, carried across with
`convert.to_torch`) and the same numpy inputs go through both on the CPU,
on the kimi-k2 (4 experts, top 2, capacity factor 2) and llama4-scout
(4 experts, top 1, capacity factor 8) smoke configs.

Tolerances and why:

  * float32 output within 1e-5 absolute at unit-scale inputs, the aux
    loss within 1e-5 relative (XLA and PyTorch sum the matmuls, the
    softmax and the mean over tokens in other orders);
  * the expert choices, each assignment's rank in its expert, the
    capacity and which assignments are dropped: equal (integers);
  * bfloat16 within 5e-2 absolute (XLA on the CPU fuses bfloat16
    elementwise chains and computes them in float32, where PyTorch rounds
    after every op), on inputs whose routing has no near-tie, so that
    both pick the same experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import mlp_fwd

ARCHS = ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e")


def _cfgs(arch, **moe_kw):
    cj = jconfigs.get_smoke_config(arch)
    ct = tconfigs.get_smoke_config(arch)
    if moe_kw:
        cj = cj.replace(moe=cj.moe.__class__(**{**cj.moe.__dict__,
                                                **moe_kw}))
        ct = ct.replace(moe=ct.moe.__class__(**{**ct.moe.__dict__,
                                                **moe_kw}))
    return cj, ct


def _params(cfg_j, seed=0, dtype="float32"):
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j, dtype)
    return pj, convert.to_torch(pj)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(cfg_j, cfg_t, pj, pt, x, dtype=jnp.float32):
    xj = jnp.asarray(x).astype(dtype)
    xt = convert.to_torch({"x": xj})["x"]
    oj, aj = jmoe.moe_fwd(pj, cfg_j, xj)
    ot, at = tmoe.moe_fwd(pt, cfg_t, xt)
    return (ot, np.asarray(oj.astype(jnp.float32)), float(at), float(aj))


def _route(pj, cfg_j, x):
    """The reference's expert choices and ranks for x (B, S, d)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jmoe.linear_fwd(pj["router"], xf).astype(
        jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg_j.moe.top_k)
    flat = idx.reshape(-1)
    return np.asarray(flat), np.asarray(
        jmoe._positions_in_expert(flat, cfg_j.moe.n_experts))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches_reference(arch):
    cfg_j, cfg_t = _cfgs(arch)
    for dtype in ("float32", "bfloat16"):
        pj = jmoe.init_moe(jax.random.PRNGKey(0), cfg_j, dtype)
        pt = tmoe.init_moe(torch.Generator().manual_seed(0), cfg_t, dtype)
        want = convert.to_torch(pj)
        assert tree.leaves(tree.map(lambda a: (tuple(a.shape), a.dtype),
                                    pt)) == tree.leaves(
            tree.map(lambda a: (tuple(a.shape), a.dtype), want))
        assert sorted(pt) == sorted(pj)
        # the reference's scales: experts at 1/sqrt(fan-in), router 0.02
        m = cfg_t.moe
        d, f = cfg_t.d_model, m.d_expert
        for key, fan in (("w_gate", d), ("w_up", d), ("w_down", f)):
            std = float(pt[key].float().std())
            assert abs(std * np.sqrt(fan) - 1) < 0.05, (key, std)
        assert abs(float(pt["router"]["w"].float().std()) - 0.02) < 0.002


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_and_aux_match_reference(arch):
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(cfg_j)
    x = _x(1, 2, 16, cfg_j.d_model)
    ot, oj, at, aj = _both(cfg_j, cfg_t, pj, pt, x)
    assert ot.dtype == torch.float32 and tuple(ot.shape) == oj.shape
    assert float(np.abs(ot.numpy() - oj).max()) <= 1e-5
    assert abs(at - aj) <= 1e-5 * abs(aj)


@pytest.mark.parametrize("arch", ARCHS)
def test_positions_in_expert_bitwise(arch):
    cfg_j, _ = _cfgs(arch)
    E = cfg_j.moe.n_experts
    for seed, n in ((0, 64), (1, 7), (2, 1)):
        flat = np.random.default_rng(seed).integers(0, E, n).astype(
            np.int32)
        want = np.asarray(jmoe._positions_in_expert(jnp.asarray(flat), E))
        got = tmoe.positions_in_expert(torch.as_tensor(flat), E)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the ranks the reference routing gives on a real input
    pj, _ = _params(cfg_j)
    flat, want = _route(pj, cfg_j, _x(3, 2, 16, cfg_j.d_model))
    got = tmoe.positions_in_expert(torch.tensor(flat), E)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_all_tied_router_picks_the_lowest_experts(arch):
    """Zero router weights: every probability is 1/E, and top-k must take
    experts 0..K-1 on every token, as `jax.lax.top_k` does."""
    cfg_j, cfg_t = _cfgs(arch)
    pj, _ = _params(cfg_j)
    pj["router"]["w"] = jnp.zeros_like(pj["router"]["w"])
    pt = convert.to_torch(pj)
    K = cfg_t.moe.top_k
    probs = torch.full((48, cfg_t.moe.n_experts), 1 / cfg_t.moe.n_experts)
    _, idx = tmoe.top_k(probs, K)
    assert bool((idx == torch.arange(K)).all())
    x = _x(4, 3, 16, cfg_j.d_model)
    flat, _ = _route(pj, cfg_j, x)
    np.testing.assert_array_equal(flat, np.tile(np.arange(K), 48))
    ot, oj, at, aj = _both(cfg_j, cfg_t, pj, pt, x)
    assert float(np.abs(ot.numpy() - oj).max()) <= 1e-5
    assert abs(at - aj) <= 1e-5 * abs(aj)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_as_the_reference(arch):
    """capacity_factor 0.5: C = max(4, int(T·K/E·0.5)) slots, so the most
    loaded experts overflow and their late assignments are dropped (they
    contribute y·0 before the shared expert)."""
    cfg_j, cfg_t = _cfgs(arch, capacity_factor=0.5)
    pj, pt = _params(cfg_j)
    x = _x(5, 2, 24, cfg_j.d_model)
    T = 48
    C = tmoe.capacity(cfg_t, T)
    m = cfg_t.moe
    assert C == max(m.min_capacity, int(T * m.top_k / m.n_experts * 0.5))
    _, pos = _route(pj, cfg_j, x)
    assert (pos >= C).sum() > 0            # drops happen
    ot, oj, at, aj = _both(cfg_j, cfg_t, pj, pt, x)
    assert float(np.abs(ot.numpy() - oj).max()) <= 1e-5
    assert abs(at - aj) <= 1e-5 * abs(aj)
    # a token whose every assignment was dropped gets the shared expert
    # alone
    dropped = torch.as_tensor((pos >= C).reshape(T, m.top_k).all(axis=1))
    assert bool(dropped.any())
    shared = mlp_fwd(cfg_t.mlp, pt["shared"], torch.as_tensor(x))
    np.testing.assert_array_equal(ot.reshape(T, -1)[dropped].numpy(),
                                  shared.reshape(T, -1)[dropped].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sized_batch_takes_min_capacity(arch):
    """T = B = 1 token (a decode step of one request): int(T·K/E·cf) is
    below min_capacity, which decides C, and nothing is dropped."""
    cfg_j, cfg_t = _cfgs(arch)
    m = cfg_t.moe
    assert int(1 * m.top_k / m.n_experts * m.capacity_factor) \
        < m.min_capacity == tmoe.capacity(cfg_t, 1)
    pj, pt = _params(cfg_j)
    x = _x(6, 1, 1, cfg_j.d_model)
    ot, oj, at, aj = _both(cfg_j, cfg_t, pj, pt, x)
    assert tuple(ot.shape) == (1, 1, cfg_j.d_model)
    assert float(np.abs(ot.numpy() - oj).max()) <= 1e-5
    assert abs(at - aj) <= 1e-5 * abs(aj)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_moe_matches_reference(arch):
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(cfg_j, dtype="bfloat16")
    x = _x(7, 2, 16, cfg_j.d_model)
    # the same routing on both sides: the reference's top-k of the bf16
    # router's probabilities has no tie at the k-th place on this input
    ot, oj, at, aj = _both(cfg_j, cfg_t, pj, pt, x, jnp.bfloat16)
    assert ot.dtype == torch.bfloat16
    assert float(np.abs(ot.float().numpy() - oj).max()) <= 5e-2
    assert abs(at - aj) <= 1e-5 * abs(aj)
