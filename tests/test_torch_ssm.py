"""The model zoo's ssm and hybrid families in the port against the reference.

falcon-mamba-7b (Mamba1 blocks) and zamba2-1.2b (Mamba2 blocks and a
shared attention block) at their smoke configs.  The same params (the
reference's, carried across with `convert.to_torch`) and the same numpy
inputs go through `repro.models` (unjitted; its flash kernel in interpret
mode) and `repro_torch.models` on the CPU.

Tolerances and why:

  * the associative scan in float32: 1e-6 of the values' scale (XLA's
    and PyTorch's `exp` differ by an ulp; the readings are under 1e-7 of
    the scale); in bfloat16 equal, as both round after every op in the
    same order;
  * the conv, Mamba layers and decode steps in float32: 1e-5 absolute at
    values up to about 10 (matmul sums in other orders; readings under
    3e-6);
  * whole-model logits in float32: 1e-4 absolute, flash on and off; loss
    within 1e-5 relative, accuracy equal; greedy tokens of prefill + 8
    decode steps equal over a float32 and a bfloat16 cache, logits within
    1e-4 over the float32 cache and 1e-3 over the bfloat16 one (a cached
    key may round to the neighbouring bfloat16: reading 2.5e-4);
  * the full configs' dtypes (bfloat16 params and compute, falcon-mamba's
    bfloat16 scan elements): falcon-mamba's logits within 1e-2 with argmax
    equal on at least 99% of positions (readings 0.0078, one bfloat16 ulp
    at the logits' magnitude, and 100%), under the reference's own
    bfloat16-against-float32 scan gap of 0.0117; zamba2's within 2e-2
    with argmax equal on at least 90% (readings 0.0137 without flash,
    0.0151 with it, and 97.5% and 96.3%): there the reference itself moves
    by 0.0137-0.0156 between its eager and jitted forms (its shared
    attention block runs eagerly, fused in jit), and one bfloat16 ulp of
    difference inside a Mamba layer spreads over the token's channels in
    the next.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm

TOL = 1e-5
ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")


def _t(a):
    return convert.to_torch({"x": a})["x"]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) if got.size else 0.0


def _close(got, want, tol):
    err = _err(got, want)
    assert err <= tol, err


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# Helpers of models.ssm
# ---------------------------------------------------------------------------

def _combine_j(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 + a2, b2 + jnp.exp(a2) * b1


def _combine_t(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 + a2, b2 + torch.exp(a2) * b1


@pytest.mark.parametrize("n", [1, 2, 7, 8, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_associative_scan_matches_jax(n, dtype):
    """Both branches of the recursion (odd and even lengths) with the
    Mamba1 combine, along axis 1 of (B, n, D, N)."""
    la = -np.abs(_normal(n, 2, n, 6, 4)) * np.float32(0.1)
    bx = _normal(n + 100, 2, n, 6, 4)
    la_j, bx_j = (jnp.asarray(a).astype(dtype) for a in (la, bx))
    want = jax.lax.associative_scan(_combine_j, (la_j, bx_j), axis=1)
    got = tssm.associative_scan(_combine_t, (_t(la_j), _t(bx_j)), axis=1)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_f32(g), _f32(w))
        else:
            _close(g, w, 1e-6 * max(1.0, float(np.abs(_f32(w)).max())))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv(with_state, dtype):
    x = jnp.asarray(_normal(0, 2, 13, 24)).astype(dtype)
    w = jnp.asarray(_normal(1, 4, 24)).astype(dtype)
    b = jnp.asarray(_normal(2, 24)).astype(dtype)
    st = jnp.asarray(_normal(3, 2, 3, 24)) if with_state else None
    want = jssm.causal_depthwise_conv(x, w, b, st)
    got = tssm.causal_depthwise_conv(_t(x), _t(w), _t(b),
                                     None if st is None else _t(st))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":      # the same bfloat16 rounding after each op
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# Mamba layers: forward (whole and ragged chunks, with and without an
# initial state) and one-token decode
# ---------------------------------------------------------------------------

def _layer(arch, seed=0):
    cfg = jconfigs.get_smoke_config(arch)
    init = jssm.init_mamba1 if cfg.ssm.kind == "mamba1" else jssm.init_mamba2
    p = init(jax.random.PRNGKey(seed), cfg)
    return cfg, p, convert.to_torch(p)


def _state(arch, cfg, seed):
    """A non-zero layer state of batch 2 (h and the conv window)."""
    st = (jssm.init_mamba1_state if arch == "falcon-mamba-7b"
          else jssm.init_mamba2_state)(cfg, 2)
    return {k: jnp.asarray(_normal(seed + i, *v.shape, scale=0.5))
            for i, (k, v) in enumerate(sorted(st.items()))}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("L", [16, 21])          # chunk 8: whole, ragged
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_layer_forward(arch, L, with_state):
    cfg, pj, pt = _layer(arch)
    fwd_j = jssm.mamba1_fwd if arch == "falcon-mamba-7b" else jssm.mamba2_fwd
    fwd_t = tssm.mamba1_fwd if arch == "falcon-mamba-7b" else tssm.mamba2_fwd
    u = _normal(5, 2, L, cfg.d_model)
    st = _state(arch, cfg, 7) if with_state else None
    y_j, s_j = fwd_j(pj, cfg, jnp.asarray(u), st)
    y_t, s_t = fwd_t(pt, cfg, torch.as_tensor(u),
                     None if st is None else convert.to_torch(st))
    _close(y_t, y_j, TOL)
    for key in ("h", "conv"):
        assert s_t[key].dtype == getattr(torch, s_j[key].dtype.name)
        _close(s_t[key], s_j[key], TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_layer_decode_from_a_state(arch):
    cfg, pj, pt = _layer(arch, seed=3)
    dec_j = (jssm.mamba1_decode if arch == "falcon-mamba-7b"
             else jssm.mamba2_decode)
    dec_t = (tssm.mamba1_decode if arch == "falcon-mamba-7b"
             else tssm.mamba2_decode)
    st_j = _state(arch, cfg, 11)
    st_t = convert.to_torch(st_j)
    for step in range(3):
        u = _normal(20 + step, 2, 1, cfg.d_model)
        y_j, st_j = dec_j(pj, cfg, jnp.asarray(u), st_j)
        y_t, st_t = dec_t(pt, cfg, torch.as_tensor(u), st_t)
        _close(y_t, y_j, TOL)
        for key in ("h", "conv"):
            _close(st_t[key], st_j[key], TOL)


def test_scan_inputs_are_what_the_layer_scans():
    """`_m1_scan_inputs` / `_m2_scan_inputs` give the scans the layer
    runs: rerunning the chunked scan on them gives the layer's state."""
    for arch in ARCHS:
        cfg, _, pt = _layer(arch)
        u = torch.as_tensor(_normal(9, 2, 19, cfg.d_model))
        c = cfg.ssm.chunk
        if arch == "falcon-mamba-7b":
            (x, dt, Bm, Cm, A), _, _ = tssm._m1_scan_inputs(pt, cfg, u)
            _, h = tssm._m1_chunked_scan(
                x, dt, Bm, Cm, A, c, torch.float32,
                torch.zeros(2, cfg.d_inner, cfg.ssm.d_state), torch.float32)
            want = tssm.mamba1_fwd(pt, cfg, u)[1]["h"]
        else:
            (x, dt, Bm, Cm, A), _, _ = tssm._m2_scan_inputs(pt, cfg, u)
            di, P, H, N = tssm.m2_dims(cfg)
            _, h = tssm._m2_chunked_scan(
                x, dt, Bm.expand(2, 19, H, N), Cm.expand(2, 19, H, N), A,
                c, torch.zeros(2, H, P, N), torch.float32)
            want = tssm.mamba2_fwd(pt, cfg, u)[1]["h"]
        assert torch.equal(h, want)


# ---------------------------------------------------------------------------
# The whole model on smoke configs
# ---------------------------------------------------------------------------

def _model(arch, **kw):
    cfg_j = jconfigs.get_smoke_config(arch).replace(attn_chunk=16, **kw)
    cfg_t = tconfigs.get_smoke_config(arch).replace(attn_chunk=16, **kw)
    params = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params, convert.to_torch(params)


def _batch(vocab, B=2, S=37, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :S], "targets": toks[:, 1:]}


def _flash_cases():
    return [("falcon-mamba-7b", False), ("zamba2-1.2b", False),
            ("zamba2-1.2b", True)]


@pytest.mark.parametrize("arch,flash", _flash_cases())
def test_forward_and_loss_match_reference(arch, flash):
    """37 tokens over chunk 8 (ragged); zamba2's shared block (two calls)
    through K6's plain version with flash, through the blocked attention
    without."""
    cfg_j, cfg_t, pj, pt = _model(arch, use_flash=flash)
    b = _batch(cfg_j.vocab)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.as_tensor(v) for k, v in b.items()}
    before = tfa.flash_attention.launches
    lj, _ = jm.forward(pj, cfg_j, bj)
    lt, aux = tm.forward(pt, cfg_t, bt)
    assert tfa.flash_attention.launches == before          # CPU: plain
    _close(lt, lj, 1e-4)
    assert float(aux) == 0.0
    (loss_j, mj), (loss_t, mt) = (jm.loss_fn(pj, cfg_j, bj),
                                  tm.loss_fn(pt, cfg_t, bt))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * float(loss_j)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]),
                                                  abs=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    for cfg in (tconfigs.get_smoke_config(arch),
                tconfigs.get_smoke_config(arch).replace(
                    param_dtype="bfloat16")):
        cfg_j = jconfigs.get_smoke_config(arch).replace(
            param_dtype=cfg.param_dtype)
        pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
        pt = tm.init_params(cfg, torch.Generator().manual_seed(0))
        want = jax.tree_util.tree_flatten_with_path(pj)[0]
        got = tree.leaves(pt)
        assert len(got) == len(want)
        for g, (path, w) in zip(got, want):
            assert tuple(g.shape) == w.shape, path
            assert g.dtype == getattr(torch, w.dtype.name), path
        assert sorted(pt) == sorted(pj)
        assert tree.size(pt) == sum(int(w.size) for _, w in want)
        assert bool(torch.isfinite(torch.cat(
            [g.float().reshape(-1) for g in got])).all())


def _dtypes(cache):
    return tree.map(lambda a: str(a.dtype).replace("torch.", ""), cache)


def _serve_both(cfg_j, cfg_t, pj, pt, steps, cache_dtype):
    """Prefill a 20-token prompt of 2, then ``steps`` greedy decode steps,
    in both packages; returns tokens, logits and the caches after prefill
    and at the end."""
    toks = tserve.prompts(cfg_j.vocab, 2, 20, seed=3)
    cj = jm.init_cache(cfg_j, 2, 20 + steps, dtype=cache_dtype)
    ct = tm.init_cache(cfg_t, 2, 20 + steps,
                       dtype=getattr(torch, jnp.dtype(cache_dtype).name))
    lj, cj = jm.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks.numpy())}, cj)
    lt, ct = tm.prefill(pt, cfg_t, {"tokens": toks}, ct)
    after = (jax.tree.map(lambda a: a.dtype.name, cj), _dtypes(ct))
    logits = [(lt, lj)]
    tj = lj[:, -1].argmax(-1)[:, None].astype(jnp.int32)
    tt = lt[:, -1].argmax(-1)[:, None].to(torch.int32)
    out_j, out_t = [tj], [tt]
    for _ in range(steps):
        lj, cj = jm.decode_step(pj, cfg_j, tj, cj)
        lt, ct = tm.decode_step(pt, cfg_t, tt, ct)
        logits.append((lt, lj))
        tj = lj[:, -1].argmax(-1)[:, None].astype(jnp.int32)
        tt = lt[:, -1].argmax(-1)[:, None].to(torch.int32)
        out_j.append(tj), out_t.append(tt)
    return (np.asarray(jnp.concatenate(out_j, 1)),
            torch.cat(out_t, 1).numpy(), logits, after, cj, ct)


def _within_one_bf16_ulp(got, want, atol):
    """|got − want| ≤ atol + one bfloat16 ulp of the larger value."""
    got, want = _f32(got), _f32(want)
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert bool((np.abs(got - want) <= atol + ulp).all()), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", [jnp.float32, jnp.bfloat16])
def test_prefill_decode_match_reference(arch, cache_dtype):
    """Prompt 20 over chunk 8, 8 greedy decode steps: equal tokens, the
    caches' dtypes after prefill those of the reference, logits and
    states within 1e-4.  Over a bfloat16 cache zamba2's keys and values,
    1e-6 away from the reference's in float32, round now and then to the
    neighbouring bfloat16 (one ulp); the decode logits then move by up to
    2.5e-4, so there the limit is 1e-3, and the cached keys and values
    are held within 1e-3 plus one bfloat16 ulp."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    tok_j, tok_t, logits, (dj, dt), cj, ct = _serve_both(
        cfg_j, cfg_t, pj, pt, 8, cache_dtype)
    np.testing.assert_array_equal(tok_t, tok_j)
    tol = 1e-4 if cache_dtype == jnp.float32 else 1e-3
    for lt, lj in logits:
        _close(lt, lj, tol)
    assert dt == dj
    for key in ("h", "conv"):
        _close(ct["ssm"][key], cj["ssm"][key], tol)
    if arch == "zamba2-1.2b":
        for key in ("k", "v"):
            if cache_dtype == jnp.float32:
                _close(ct["attn"][key], cj["attn"][key], 1e-4)
            else:
                _within_one_bf16_ulp(ct["attn"][key], cj["attn"][key],
                                     1e-3)
        np.testing.assert_array_equal(ct["attn"]["idx"].numpy(),
                                      np.asarray(cj["attn"]["idx"]))
    assert int(ct["pos"]) == int(cj["pos"]) == 28


def test_serve_driver_runs_both_families_on_cpu():
    for arch in ARCHS:
        cfg = tconfigs.get_smoke_config(arch)
        params = tm.init_params(cfg, torch.Generator().manual_seed(0))
        res = tserve.serve(params, cfg, tserve.prompts(cfg.vocab, 2, 10), 5)
        assert res["tokens"].shape == (2, 5)
        assert bool(((res["tokens"] >= 0)
                     & (res["tokens"] < cfg.vocab)).all())


# ---------------------------------------------------------------------------
# The full configs' dtypes at smoke width
# ---------------------------------------------------------------------------

def _full_dtypes(arch, **kw):
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16", **kw)
    cfg_j, cfg_t, pj, pt = _model(arch, **kw)
    scan = jconfigs.get_config(arch).ssm.scan_dtype
    cfg_j = cfg_j.replace(ssm=dataclasses.replace(cfg_j.ssm, scan_dtype=scan))
    cfg_t = cfg_t.replace(ssm=dataclasses.replace(cfg_t.ssm, scan_dtype=scan))
    return cfg_j, cfg_t, pj, pt


BF16_LIMITS = {"falcon-mamba-7b": (1e-2, 0.99), "zamba2-1.2b": (2e-2, 0.9)}


@pytest.mark.parametrize("arch,flash", _flash_cases())
def test_full_config_dtypes_forward(arch, flash):
    cfg_j, cfg_t, pj, pt = _full_dtypes(arch, use_flash=flash)
    b = _batch(cfg_j.vocab, S=40)
    lj, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(b["tokens"])})
    lt, _ = tm.forward(pt, cfg_t, {"tokens": torch.as_tensor(b["tokens"])})
    assert lt.dtype == torch.bfloat16
    tol, share = BF16_LIMITS[arch]
    _close(lt, lj, tol)
    agree = (lt.argmax(-1).numpy() == np.asarray(lj.argmax(-1))).mean()
    assert agree >= share, agree


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_dtypes_serve_over_float32_cache(arch):
    """What `launch.serve` does at full size: a bfloat16 model over a
    float32 cache.  zamba2's decode promotes to float32 at its first
    shared attention block, falcon-mamba's stays bfloat16; the conv state
    after prefill is bfloat16, as in the reference."""
    cfg_j, cfg_t, pj, pt = _full_dtypes(arch)
    tok_j, tok_t, logits, (dj, dt), _, _ = _serve_both(
        cfg_j, cfg_t, pj, pt, 8, jnp.float32)
    assert dt == dj and dt["ssm"]["conv"] == "bfloat16"
    want = torch.float32 if arch == "zamba2-1.2b" else torch.bfloat16
    assert all(lt.dtype == want for lt, _ in logits[1:])
    assert all(lt.dtype == getattr(torch, lj.dtype.name) for lt, lj in logits)
    tol, share = BF16_LIMITS[arch]
    assert (tok_t == tok_j).mean() >= share
    for lt, lj in logits:
        _close(lt, lj, tol)
