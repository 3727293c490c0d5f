"""The model zoo's decoder (every family) in the port against the
reference.

The same params (the reference's, carried across with `convert.to_torch`)
and the same numpy inputs go through `repro.models` (unjitted; its flash
kernel in interpret mode) and `repro_torch.models` on the CPU.

Tolerances and why:

  * layers and attention in float32: 2e-6 absolute at unit-scale inputs
    (XLA and PyTorch sum matmuls and reductions in different orders;
    `exp`, `cos` and `rsqrt` differ by an ulp between the two libraries);
  * whole-model logits in float32: 1e-4 absolute, flash on and off
    (tests/test_properties.py allows 2e-4 for flash against the jnp
    path); loss within 1e-5 relative, accuracy equal;
  * greedy tokens of prefill + 8 decode steps: equal; the KV cache within
    1e-4 absolute;
  * bfloat16: XLA on the CPU fuses bfloat16 elementwise chains and
    computes them in float32, where PyTorch rounds after every op, so
    logits agree to a few bfloat16 ulps of their scale: 5e-2 absolute on
    logits of magnitude about 1, and greedy tokens on at least 90% of
    positions of a two-layer model (1e-1 for a MoE's decode over a
    float32 cache: `test_bfloat16_family_over_float32_cache_decode`);
  * the MoE aux loss within 1e-5 relative; the audio family's cross
    cache as the KV cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.synthetic import make_token_dataset as j_tokens
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.data import make_token_dataset as t_tokens
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

TOL = 2e-6
ARCHS = ("smollm-360m", "qwen1.5-0.5b", "olmo-1b")
# the moe, vlm and audio families
NEW_ARCHS = ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "qwen2-vl-72b",
             "whisper-large-v3")


def _t(a):
    return convert.to_torch({"x": a})["x"]


def _close(got, want, tol):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, err


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for get in ("get_config", "get_smoke_config"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_params(), t.active_params()) == (j.n_params(),
                                                     j.active_params())
    lc_j = jconfigs.long_context_variant(jconfigs.get_config(arch), 4096)
    lc_t = tconfigs.long_context_variant(tconfigs.get_config(arch), 4096)
    assert dataclasses.asdict(lc_t) == dataclasses.asdict(lc_j)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_tree_matches_reference(arch):
    """`init_params` builds the reference's tree (keys, shapes, dtypes:
    the moe leaves (L, E, d, f), the audio family's ``encoder`` subtree),
    and `convert.to_torch` carries the reference's params across leaf for
    leaf, bit for bit."""
    cfg_j = jconfigs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg_t = tconfigs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = tm.init_params(cfg_t, torch.Generator().manual_seed(0))
    shapes = lambda t: tree.leaves(tree.map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), t))
    carried = convert.to_torch(pj)
    assert shapes(pt) == shapes(carried)
    assert tree.map(lambda a: None, pt) == tree.map(lambda a: None, carried)
    for got, want in zip(tree.leaves(carried),
                         jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    if cfg_t.family == "moe":
        m = cfg_t.moe
        assert tuple(pt["blocks"]["moe"]["w_gate"].shape) == (
            cfg_t.n_layers, m.n_experts, cfg_t.d_model, m.d_expert)
    if cfg_t.family == "audio":
        assert sorted(pt["encoder"]) == ["blocks", "final_norm"]
        assert sorted(pt["blocks"]) == ["attn", "cross", "mlp", "norm1",
                                        "norm2", "norm_x"]


def test_make_token_dataset_bit_identical():
    for args in ((0, 16, 33, 512), (5, 3, 10, 3)):
        a, b = j_tokens(*args), t_tokens(*args)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_token_batches_match_reference_draws():
    from repro.launch.train import make_batches
    toks = t_tokens(1, 20, 17, 64)
    cfg = jconfigs.get_smoke_config("smollm-360m")
    want = make_batches(cfg, toks, (2, 3), 16, np.random.default_rng(4))
    got = tserve.make_token_batches(toks, (2, 3), 16,
                                    np.random.default_rng(4))
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def test_convert_bfloat16_round_trip_bit_exact():
    a = jnp.asarray(_normal(0, 5, 7) * 100).astype(jnp.bfloat16)
    a = a.at[0, :4].set(jnp.asarray([0.0, -0.0, jnp.inf, -jnp.inf],
                                    jnp.bfloat16))
    t = convert.to_torch({"a": {"w": a}})["a"]["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
    back = jnp.asarray(convert.to_numpy({"w": t})["w"])
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back).view(np.uint16),
                                  np.asarray(a).view(np.uint16))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms(kind):
    x = _normal(0, 2, 5, 48) * 3 + 1
    p = {k: _normal(i + 1, 48) for i, k in enumerate(
        jl.init_norm(kind, 48).keys())}
    want = jl.norm_fwd(kind, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), 1e-5)
    got = tl.norm_fwd(kind, {k: torch.as_tensor(v) for k, v in p.items()},
                      torch.as_tensor(x), 1e-5)
    _close(got, want, TOL)


def test_rope_freqs_bitwise_and_apply_rope():
    for hd, theta in ((64, 1e4), (80, 1e4), (32, 1e6)):
        np.testing.assert_array_equal(
            tl.rope_freqs(hd, theta).numpy().view(np.uint32),
            np.asarray(jl.rope_freqs(hd, theta)).view(np.uint32))
    pos = np.arange(40)[None].repeat(2, 0)
    ang_j = jl.rope_angles(jnp.asarray(pos), 16, 1e4)
    ang_t = tl.rope_angles(torch.as_tensor(pos), 16, 1e4)
    _close(ang_t, ang_j, 0.0)
    x = _normal(1, 2, 40, 3, 16)
    _close(tl.apply_rope(torch.as_tensor(x), ang_t),
           jl.apply_rope(jnp.asarray(x), ang_j), TOL)
    # (S, D/2) angles broadcast over the batch
    _close(tl.apply_rope(torch.as_tensor(x), ang_t[0]),
           jl.apply_rope(jnp.asarray(x), ang_j[0]), TOL)


def test_mrope_angles():
    pos3 = np.stack([np.arange(12), np.arange(12) // 3, np.arange(12) % 3])
    pos3 = pos3[:, None].repeat(2, 1)
    _close(tl.mrope_angles(torch.as_tensor(pos3), 32, 1e4, (2, 1, 1)),
           jl.mrope_angles(jnp.asarray(pos3), 32, 1e4, (2, 1, 1)), 0.0)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    p = jl.init_mlp(jax.random.PRNGKey(0), 32, 96, kind)
    x = _normal(2, 2, 7, 32)
    _close(tl.mlp_fwd(kind, convert.to_torch(p), torch.as_tensor(x)),
           jl.mlp_fwd(kind, p, jnp.asarray(x)), TOL)


def test_embed_linear_unembed():
    emb = jl.init_embedding(jax.random.PRNGKey(1), 50, 24)
    lin = jl.init_linear(jax.random.PRNGKey(2), 24, 10, bias=True)
    lin["b"] = jnp.asarray(_normal(3, 10))
    toks = np.array([[0, 49, 7], [3, 3, 1]], np.int32)
    x_j = jl.embed_fwd(emb, jnp.asarray(toks), jnp.float32)
    x_t = tl.embed_fwd(convert.to_torch(emb), torch.as_tensor(toks),
                       torch.float32)
    _close(x_t, x_j, 0.0)
    _close(tl.linear_fwd(convert.to_torch(lin), x_t),
           jl.linear_fwd(lin, x_j), TOL)
    _close(tl.unembed_fwd(convert.to_torch(emb), x_t),
           jl.unembed_fwd(emb, x_j), TOL)


# ---------------------------------------------------------------------------
# Attention: three branches, the cache, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,chunk,causal,window,q_offset", [
    (24, 32, True, 0, 0),        # Sq <= chunk: one piece
    (40, 64, False, 8, 3),       # Sq <= chunk, window and offset
    (100, 16, True, 0, 0),       # causal skip, 7 chunks
    (300, 16, True, 0, 0),       # causal skip, chunk doubled to 32 (10)
    (70, 16, True, 12, 0),       # scanned chunks: sliding window
    (50, 16, True, 0, 4),        # scanned chunks: q offset
    (45, 16, False, 0, 0),       # scanned chunks: non-causal
])
def test_attention_branches(sq, chunk, causal, window, q_offset):
    sk = sq + q_offset
    q = _normal(0, 2, sq, 6, 16)
    k = _normal(1, 2, sk, 2, 16)
    v = _normal(2, 2, sk, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    got = tattn.attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), **kw)
    _close(got, want, TOL)


@pytest.mark.parametrize("writes", [(5,), (3, 4), (6, 1, 1, 5), (13,)])
def test_cache_write_ring_buffer(writes):
    """A cache of 6 slots: plain appends, a wrap across the end, and one
    write longer than the cache (the last 6 tokens stay)."""
    jc = jattn.init_kv_cache(2, 6, 2, 4, dtype=jnp.float32)
    tc = tattn.init_kv_cache(2, 6, 2, 4, dtype=torch.float32)
    for i, n in enumerate(writes):
        kn, vn = _normal(10 + i, 2, n, 2, 4), _normal(20 + i, 2, n, 2, 4)
        jc = jattn.cache_write(jc, jnp.asarray(kn), jnp.asarray(vn))
        tc = tattn.cache_write(tc, torch.as_tensor(kn), torch.as_tensor(vn))
        for key in ("k", "v"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        assert int(tc["idx"]) == int(jc["idx"])
        assert tc["idx"].dtype == torch.int32


@pytest.mark.parametrize("filled", [3, 6, 9])
def test_decode_attend(filled):
    """Partly filled, full, and wrapped caches; bfloat16 q over a float32
    cache promotes as jnp does (float32 out)."""
    C = 6
    jc = jattn.init_kv_cache(2, C, 2, 8, dtype=jnp.float32)
    tc = tattn.init_kv_cache(2, C, 2, 8, dtype=torch.float32)
    kn, vn = _normal(1, 2, filled, 2, 8), _normal(2, 2, filled, 2, 8)
    for step in range(filled):
        sl = slice(step, step + 1)
        jc = jattn.cache_write(jc, jnp.asarray(kn[:, sl]),
                               jnp.asarray(vn[:, sl]))
        tc = tattn.cache_write(tc, torch.as_tensor(kn[:, sl]),
                               torch.as_tensor(vn[:, sl]))
    q = _normal(3, 2, 1, 6, 8)
    _close(tattn.decode_attend(torch.as_tensor(q), tc),
           jattn.decode_attend(jnp.asarray(q), jc), TOL)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    want = jattn.decode_attend(qb, jc)
    got = tattn.decode_attend(_t(qb), tc)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, TOL)


# ---------------------------------------------------------------------------
# The whole slice on smoke configs
# ---------------------------------------------------------------------------

def _model(arch, **kw):
    cfg_j = jconfigs.get_smoke_config(arch).replace(attn_chunk=16, **kw)
    cfg_t = tconfigs.get_smoke_config(arch).replace(attn_chunk=16, **kw)
    params = jm.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params, convert.to_torch(params)


def _extras(cfg, B=2, seed=2):
    """The family's inputs beside the tokens, from a numpy seed: patches
    (B, n_patches, d) for the vlm family, frames (B, n_audio_frames, d)
    for the audio family."""
    rng = np.random.default_rng(seed)
    n = {"vlm": ("patches", cfg.n_patches),
         "audio": ("frames", cfg.n_audio_frames)}.get(cfg.family)
    if n is None:
        return {}
    return {n[0]: rng.normal(size=(B, n[1], cfg.d_model)).astype(np.float32)}


def _batch(vocab, B=2, S=40, seed=1, cfg=None):
    toks = t_tokens(seed, B, S, vocab)
    b = {"tokens": toks[:, :S], "targets": toks[:, 1:S + 1]}
    if cfg is not None:
        b.update(_extras(cfg, B))
    return b


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_forward_and_loss_match_reference(arch):
    """S = 40 over attn_chunk 16 takes the causal-skip branch without
    flash; with flash every causal self-attention is K6's plain version.
    The vlm family attends over 16 patches + 40 tokens; the audio
    encoder's 24 frames and the cross-attention take the non-causal
    q-chunk branch.  The MoE aux loss, summed over the layers, within
    1e-5 relative (0 elsewhere)."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    b = _batch(cfg_j.vocab, cfg=cfg_t)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.as_tensor(v) for k, v in b.items()}
    for flash in (False, True):
        cj, ct = (c.replace(use_flash=flash) for c in (cfg_j, cfg_t))
        before = tfa.flash_attention.launches
        lj, aux_j = jm.forward(pj, cj, bj)
        lt, aux = tm.forward(pt, ct, bt)
        assert tfa.flash_attention.launches == before      # CPU: plain
        _close(lt, lj, 1e-4)
        if cfg_t.family == "moe":
            assert float(aux) > 0
            assert abs(float(aux) - float(aux_j)) <= 1e-5 * float(aux_j)
        else:
            assert float(aux) == 0.0
        (loss_j, mj), (loss_t, mt) = (jm.loss_fn(pj, cj, bj),
                                      tm.loss_fn(pt, ct, bt))
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * float(loss_j)
        assert float(mt["accuracy"]) == pytest.approx(
            float(mj["accuracy"]), abs=1e-7)


def test_loss_mask_matches_reference():
    cfg_j, cfg_t, pj, pt = _model("smollm-360m")
    b = _batch(cfg_j.vocab, S=12)
    mask = (np.arange(12)[None].repeat(2, 0) % 3 != 0).astype(np.float32)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.as_tensor(v) for k, v in b.items()}
    bj["loss_mask"], bt["loss_mask"] = jnp.asarray(mask), torch.as_tensor(
        mask)
    (lj, mj), (lt, mt) = jm.loss_fn(pj, cfg_j, bj), tm.loss_fn(pt, cfg_t, bt)
    assert abs(float(lt) - float(lj)) <= 1e-5 * float(lj)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]),
                                                  abs=1e-7)


def _jax_decode_loop(pj, cfg, tok, cache):
    """The reference's decode step with its layer scan written as a loop
    of its own block function (the scan refuses a carry whose dtype
    changes, which a float32 cache under a bfloat16 model causes): the
    vlm position offset and the audio cross cache as its `decode_step`
    passes them."""
    x = jl.embed_fwd(pj["embed"], tok, jnp.dtype(cfg.compute_dtype))
    pos = cache["pos"][None].repeat(x.shape[0], 0)[:, None]
    if cfg.family == "vlm":
        pos = pos - cfg.n_patches + int(max(cfg.patch_grid))
    angles = jm._angles_for(cfg, pos)
    kv = cache["kv"]
    ks, vs, idxs = [], [], []
    for i in range(cfg.n_layers):
        layer = jax.tree.map(lambda a: a[i], kv)
        cross = None
        if "cross" in cache:
            cross = jax.tree.map(lambda a: a[i], cache["cross"])
        x, layer = jm._attn_block_with_cache(
            jax.tree.map(lambda a: a[i], pj["blocks"]), cfg, x, angles,
            layer, cross_cache=cross, decode=True)
        ks.append(layer["k"]), vs.append(layer["v"]), idxs.append(
            layer["idx"])
    cache = dict(cache, pos=cache["pos"] + 1,
                 kv={"k": jnp.stack(ks), "v": jnp.stack(vs),
                     "idx": jnp.stack(idxs)})
    x = jl.norm_fwd(cfg.norm, pj["final_norm"], x, cfg.norm_eps)
    return jl.unembed_fwd(pj["unembed"], x), cache


def _serve_both(cfg_j, cfg_t, pj, pt, steps, cache_dtype, jax_decode):
    toks = tserve.prompts(cfg_j.vocab, 2, 20, seed=3)
    extras = _extras(cfg_t)
    n = tserve.cache_length(cfg_t, 20, steps)
    cj = jm.init_cache(cfg_j, 2, n, dtype=cache_dtype)
    ct = tm.init_cache(cfg_t, 2, n,
                       dtype=getattr(torch, jnp.dtype(cache_dtype).name))
    bj = {k: jnp.asarray(v) for k, v in extras.items()}
    bt = {k: torch.as_tensor(v) for k, v in extras.items()}
    lj, cj = jm.prefill(pj, cfg_j, dict(bj, tokens=jnp.asarray(
        toks.numpy())), cj)
    lt, ct = tm.prefill(pt, cfg_t, dict(bt, tokens=toks), ct)
    logits = [(lt, lj)]
    tj = lj[:, -1].argmax(-1)[:, None].astype(jnp.int32)
    tt = lt[:, -1].argmax(-1)[:, None].to(torch.int32)
    out_j, out_t = [tj], [tt]
    for _ in range(steps):
        lj, cj = jax_decode(pj, cfg_j, tj, cj)
        lt, ct = tm.decode_step(pt, cfg_t, tt, ct)
        logits.append((lt, lj))
        tj = lj[:, -1].argmax(-1)[:, None].astype(jnp.int32)
        tt = lt[:, -1].argmax(-1)[:, None].to(torch.int32)
        out_j.append(tj), out_t.append(tt)
    return (np.asarray(jnp.concatenate(out_j, 1)),
            torch.cat(out_t, 1).numpy(), logits, cj, ct)


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS)
def test_prefill_decode_match_reference(arch):
    """Prompt 20 over attn_chunk 16 (causal-skip prefill; the vlm
    family's 16 patches ahead of it), 8 greedy decode steps: equal
    tokens, the KV cache (and the audio family's cross cache) and logits
    within 1e-4, equal token counts and position."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    tok_j, tok_t, logits, cj, ct = _serve_both(
        cfg_j, cfg_t, pj, pt, 8, jnp.float32, jm.decode_step)
    np.testing.assert_array_equal(tok_t, tok_j)
    for lt, lj in logits:
        _close(lt, lj, 1e-4)
    for key in ("k", "v"):
        _close(ct["kv"][key], cj["kv"][key], 1e-4)
        if "cross" in cj:
            _close(ct["cross"][key], cj["cross"][key], 1e-4)
    assert sorted(ct) == sorted(cj)
    np.testing.assert_array_equal(ct["kv"]["idx"].numpy(),
                                  np.asarray(cj["kv"]["idx"]))
    patches = cfg_t.n_patches if cfg_t.family == "vlm" else 0
    assert int(ct["pos"]) == int(cj["pos"]) == 28 + patches


def test_sliding_window_ring_cache_decode():
    """A 12-token window: the cache is a 12-slot ring that the 20-token
    prompt overflows and decode keeps wrapping."""
    cfg_j, cfg_t, pj, pt = _model("smollm-360m", sliding_window=12)
    tok_j, tok_t, logits, cj, ct = _serve_both(
        cfg_j, cfg_t, pj, pt, 8, jnp.float32, jm.decode_step)
    assert ct["kv"]["k"].shape[2] == 12
    np.testing.assert_array_equal(tok_t, tok_j)
    for lt, lj in logits:
        _close(lt, lj, 1e-4)
    _close(ct["kv"]["k"], cj["kv"]["k"], 1e-4)


def test_bfloat16_model_forward():
    """bfloat16 params and compute, flash on and off."""
    cfg_j, cfg_t, pj, pt = _model("smollm-360m", param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    b = _batch(cfg_j.vocab)
    for flash in (False, True):
        cj, ct = (c.replace(use_flash=flash) for c in (cfg_j, cfg_t))
        lj, _ = jm.forward(pj, cj, {"tokens": jnp.asarray(b["tokens"])})
        lt, _ = tm.forward(pt, ct, {"tokens": torch.as_tensor(b["tokens"])})
        assert lt.dtype == torch.bfloat16
        _close(lt, lj, 5e-2)
        agree = (lt.argmax(-1).numpy() == np.asarray(lj.argmax(-1))).mean()
        assert agree >= 0.9, agree


def test_bfloat16_model_over_float32_cache_decode():
    """The serving driver's case: a bfloat16 model over a float32 cache.
    Decode promotes to float32 after the first layer's attention, as the
    reference's blocks do when called one by one."""
    cfg_j, cfg_t, pj, pt = _model("smollm-360m", param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    tok_j, tok_t, logits, cj, ct = _serve_both(
        cfg_j, cfg_t, pj, pt, 8, jnp.float32, _jax_decode_loop)
    assert logits[0][0].dtype == torch.bfloat16         # prefill
    assert all(lt.dtype == torch.float32 for lt, _ in logits[1:])
    assert ct["kv"]["k"].dtype == torch.float32
    assert (tok_t == tok_j).mean() >= 0.9
    for lt, lj in logits:
        _close(lt, lj, 5e-2)


@pytest.mark.parametrize("arch", ("kimi-k2-1t-a32b", "whisper-large-v3"))
def test_bfloat16_family_forward(arch):
    """bfloat16 params and compute for a MoE and the encoder-decoder,
    flash on and off, at `test_bfloat16_model_forward`'s limits."""
    cfg_j, cfg_t, pj, pt = _model(arch, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    b = _batch(cfg_j.vocab, cfg=cfg_t)
    bj = {k: jnp.asarray(v) for k, v in b.items() if k != "targets"}
    bt = {k: torch.as_tensor(v) for k, v in b.items() if k != "targets"}
    for flash in (False, True):
        cj, ct = (c.replace(use_flash=flash) for c in (cfg_j, cfg_t))
        lj, _ = jm.forward(pj, cj, bj)
        lt, _ = tm.forward(pt, ct, bt)
        assert lt.dtype == torch.bfloat16
        _close(lt, lj, 5e-2)
        agree = (lt.argmax(-1).numpy() == np.asarray(lj.argmax(-1))).mean()
        assert agree >= 0.9, agree


@pytest.mark.parametrize("arch", ("kimi-k2-1t-a32b", "whisper-large-v3"))
def test_bfloat16_family_over_float32_cache_decode(arch):
    """What `launch.serve` runs, for a MoE and the encoder-decoder: a
    bfloat16 model over a float32 cache (the cross cache too), held
    against the reference's blocks called one by one.

    The reference's prefill runs its layer scan compiled, where XLA
    fuses bfloat16 chains, and the port rounds after every op; the MoE
    block rounds four more bfloat16 stages (expert products, gating,
    combine, shared expert) than a dense one.  The cached keys and
    values carry those differences into every decode step, where the
    kimi-k2 smoke model's logits move up to 8.2e-2 with the same experts
    chosen on every token, so its logits are held within 1e-1; the
    encoder-decoder's within the dense model's 5e-2."""
    cfg_j, cfg_t, pj, pt = _model(arch, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    tol = 1e-1 if cfg_t.family == "moe" else 5e-2
    tok_j, tok_t, logits, cj, ct = _serve_both(
        cfg_j, cfg_t, pj, pt, 8, jnp.float32, _jax_decode_loop)
    assert logits[0][0].dtype == torch.bfloat16         # prefill
    assert all(lt.dtype == torch.float32 for lt, _ in logits[1:])
    assert ct["kv"]["k"].dtype == torch.float32
    if "cross" in cj:
        assert ct["cross"]["k"].dtype == torch.float32
        for key in ("k", "v"):
            _close(ct["cross"][key], cj["cross"][key], 5e-2)
    assert (tok_t == tok_j).mean() >= 0.9
    for lt, lj in logits:
        _close(lt, lj, tol)


def test_serve_driver_on_cpu():
    cfg = tconfigs.get_smoke_config("olmo-1b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree.size(params) == cfg.n_params()
    res = tserve.serve(params, cfg, tserve.prompts(cfg.vocab, 2, 10), 5)
    assert res["tokens"].shape == (2, 5)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0


class _Drawn(Exception):
    """Stops the reference's `launch.serve.main` once it has drawn its
    requests."""


@pytest.mark.parametrize("arch", ("qwen2-vl-72b", "whisper-large-v3"))
def test_serve_extras_on_cpu(arch, monkeypatch):
    """The vlm patches and audio frames: `request_batch` draws what the
    reference's `launch.serve.main` draws (run until it asks for a cache,
    with its numpy generator recorded), `cache_length` is its cache
    length, and `serve` runs them on the CPU."""
    from types import SimpleNamespace

    from repro.launch import serve as jserve

    draws, seen = [], {}

    class Recorded:
        def __init__(self, seed):
            self.rng = np.random.default_rng(seed)

        def __getattr__(self, name):
            def draw(*args, **kwargs):
                out = getattr(self.rng, name)(*args, **kwargs)
                draws.append(out)
                return out
            return draw

    def stop(cfg, B, cache_len, dtype):
        seen["cache_len"] = cache_len
        raise _Drawn

    monkeypatch.setattr(jserve, "np", SimpleNamespace(
        random=SimpleNamespace(default_rng=Recorded)))
    monkeypatch.setattr(jserve, "init_params", lambda cfg, key: None)
    monkeypatch.setattr(jserve, "init_cache", stop)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--batch",
                                     "2", "--prompt-len", "12", "--gen",
                                     "5"])
    with pytest.raises(_Drawn):
        jserve.main()
    cfg = tconfigs.get_smoke_config(arch)
    got = tserve.request_batch(cfg, 2, 12)
    extra = "patches" if cfg.family == "vlm" else "frames"
    assert sorted(got) == sorted(["tokens", extra]) and len(draws) == 2
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  draws[0].astype(np.int32))
    np.testing.assert_array_equal(got[extra].numpy(),
                                  draws[1].astype(np.float32))
    assert tserve.cache_length(cfg, 12, 5) == seen["cache_len"]
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    res = tserve.serve(params, cfg, got.pop("tokens"), 5, **got)
    assert res["tokens"].shape == (2, 5)
    assert bool(torch.isfinite(res["last_logits"]).all())
