"""The model zoo's decoder: all six architecture families.

Port of `repro.models.model` for every ``cfg.family``: "dense"
(smollm-360m, qwen1.5-0.5b, olmo-1b, codeqwen1.5-7b), "moe" (kimi-k2,
llama4-scout: the dense block with its MLP replaced by `models.moe`),
"ssm" (falcon-mamba-7b: a stack of Mamba1 blocks), "hybrid" (zamba2-1.2b:
Mamba2 blocks with one shared attention block after every
``cfg.attn_every`` of them), "vlm" (qwen2-vl-72b: dense blocks over
[patch embeddings; tokens] with M-RoPE positions) and "audio"
(whisper-large-v3: a non-causal encoder over precomputed frames, and a
decoder whose blocks cross-attend to its output).  Public API, as the
reference's:

  init_params(cfg, generator, device)              -> params
  forward(params, cfg, batch)                      -> (logits, aux_loss)
  loss_fn(params, cfg, batch)                      -> (loss, metrics)
  init_cache(cfg, batch, cache_len, dtype, device) -> cache
  prefill(params, cfg, batch, cache)               -> (logits, cache)
  decode_step(params, cfg, tokens, cache)          -> (logits, cache)

``batch`` holds tokens (B, S) and, for the vlm family, patches
(B, P, d), for the audio family frames (B, F, d).  Params keep the
reference's stacked layout: every leaf of ``params["blocks"]`` (and of
the audio encoder's) has a leading layer axis, so `convert.to_torch`
carries a JAX param tree across as it is.  The reference scans the layer
stack; here a Python loop walks it.  With ``cfg.use_flash`` every causal
self-attention of `forward` (the dense, moe, vlm and audio decoder
blocks, zamba2's shared block) runs kernel K6
(`kernels.ops.attention_pallas`); the audio encoder and the
cross-attention, `prefill` and `decode_step` use `models.attention`, as
the reference does.  The Mamba blocks run the reference's chunked scans
(`models.ssm`), which call neither K7 nor K8, as in the reference.

`forward` and `loss_fn` are differentiable with autograd (the training
path, `core.fed_step`).  When params require grad, ``cfg.remat`` wraps
each block body where the reference wraps it in `jax.checkpoint` (the
encoder's and the decoder's blocks, the Mamba blocks; not zamba2's
shared block) in `torch.utils.checkpoint.checkpoint`, which recomputes
the block in the backward pass; the stacked layers are unbound once, so
their grads stack back in one copy.  K6 has no backward kernel (the
reference cannot differentiate through its Pallas kernel either), so a
``cfg.use_flash`` forward over params that require grad raises rather
than train without attention's gradients.

On a device mesh (params and inputs as DTensors placed by
`sharding.rules`, inside `sharding.ctx.mesh_context`) DTensor runs the
matmuls, norms and elementwise work by sharding propagation; the
residual stream is pinned (batch on the data axes, replicated on
"model", or with ``seq_parallel`` the sequence on "model") after every
residual add and block, where the reference pins it between blocks;
attention (K6, the plain version and the cache paths) runs on each
rank's (batch, heads) block in a local region (`attention.local_heads`);
the Mamba mixers run tensor parallel over "model" on each rank's batch
block and block of d_inner (Mamba2: of the heads), their out_proj's
partial sums reduced by the residual pin, their decode states kept in
`cache_pspecs`' placements (`_mixer`, `ssm.mixer_tp`; replicated on
"model" with their weights gathered where it does not cut them into
whole blocks); the MoE runs as `moe_fwd` says; the loss gathers the
vocab.  Off a mesh every pin is a no-op.

Serving with a float32 cache under a bfloat16 model (what
`launch.serve` does) promotes as jnp does: a decode attention reads
float32 keys, so its output and from there the residual stream are
float32 (every attention family's layers; zamba2 after its first shared
block; never falcon-mamba, whose float32 SSM state is cast back to the
stream's dtype).  The reference's scanned `decode_step` refuses that
change of carry dtype; its blocks, called one by one, compute what the
loop here computes.  The SSM states are replaced by each prefill and
decode step (stacked per layer, promoted as jnp's concatenate does), so
the conv state takes the stream's dtype as in the reference; the KV and
cross caches are written in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as tree_util
from ..kernels.ops import attention_pallas
from ..sharding import ctx
from . import attention as attn
from . import ssm
from .config import ModelConfig
from .layers import (apply_rope, dtype_of, embed_fwd, init_embedding,
                     init_mlp, init_norm, linear_fwd, mlp_fwd, mrope_angles,
                     norm_fwd, rope_angles, unembed_fwd)
from .moe import init_moe, moe_fwd

# families whose layers are transformer blocks over a KV cache
_ATTENTION = ("dense", "moe", "vlm", "audio")
_FAMILIES = _ATTENTION + ("ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _layer(blocks: dict, i: int) -> dict:
    return tree_util.map(lambda a: a[i], blocks)


def _layers(blocks: dict, n: int) -> List[dict]:
    """Every layer of a stack as views, from one `unbind` per leaf (whose
    backward stacks the layers' grads in one copy)."""
    parts = tree_util.map(lambda a: a.unbind(0), blocks)
    return [tree_util.map(lambda t: t[i], parts) for i in range(n)]


def _trains(params: dict, cfg: ModelConfig) -> bool:
    """Will autograd record this forward?  Refuses K6 if so."""
    trains = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_util.leaves(params))
    if trains and cfg.use_flash:
        raise RuntimeError(
            "use_flash=True under autograd: kernel K6 "
            "(kernels.flash_attention) has no backward kernel, so "
            "attention's gradients would be lost; train with "
            "use_flash=False (plain attention, as the reference trains)")
    return trains


def _block(fn: Callable, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward pass when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stacked(init, n: int) -> dict:
    """n layers of ``init()`` stacked on a leading axis.  The stack is
    allocated once and each layer copied in as it is drawn, so a
    full-width init holds the stack and one layer, never two stacks."""
    first = init()
    if n == 1:
        return tree_util.map(lambda a: a[None], first)
    stack = tree_util.map(
        lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), first)
    for i in range(n):
        layer = first if i == 0 else init()
        tree_util.map(lambda s, a: s[i].copy_(a), stack, layer)
        first = layer = None
    return stack


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_transformer_block(gen: torch.Generator, cfg: ModelConfig,
                            device, kind: str = "dense") -> dict:
    """kind: 'dense' | 'moe' | 'enc' | 'dec_cross', as the reference's."""
    hd = cfg.derived_head_dim()
    dt = cfg.param_dtype
    p = {
        "norm1": init_norm(cfg.norm, cfg.d_model, dt, device),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, cfg.qkv_bias, dt,
                                    device),
        "norm2": init_norm(cfg.norm, cfg.d_model, dt, device),
    }
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, dt, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt, device)
    if kind == "dec_cross":
        p["norm_x"] = init_norm(cfg.norm, cfg.d_model, dt, device)
        p["cross"] = attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, hd, cfg.qkv_bias,
                                         dt, device)
    return p


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP or MoE, and its aux loss (0 for an MLP)."""
    if "moe" in p:
        return moe_fwd(p["moe"], cfg, x)
    return mlp_fwd(cfg.mlp, p["mlp"], x), _zero(x)


def _zero(x: torch.Tensor) -> torch.Tensor:
    """A float32 0 to sum aux losses into, replicated on ``x``'s mesh."""
    return ctx.like(torch.zeros((), dtype=torch.float32, device=x.device),
                    x)


def _transformer_block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           angles: Optional[torch.Tensor], *, causal: bool,
                           window: int,
                           enc_out: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block (dense, moe, encoder, or with ``enc_out`` a decoder
    block that cross-attends to it) -> (x, aux loss)."""
    hd = cfg.derived_head_dim()
    x = _pin(cfg, x)
    h = norm_fwd(cfg.norm, p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, hd)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    if cfg.use_flash and causal:
        o = attn.local_heads(lambda q, k, v: attention_pallas(
            q, k, v, causal=True, window=window), q, k, v,
            n_kv_heads=cfg.n_kv_heads)
    else:
        o = attn.local_heads(lambda q, k, v: attn.attention(
            q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk),
            q, k, v, n_kv_heads=cfg.n_kv_heads)
    x = _pin(cfg, x + linear_fwd(p["attn"]["wo"], o))
    if enc_out is not None:
        h = norm_fwd(cfg.norm, p["norm_x"], x, cfg.norm_eps)
        q2 = _cross_q(p["cross"], cfg, h)
        k2, v2 = _cross_kv(p["cross"], cfg, enc_out)
        o2 = attn.local_heads(lambda q, k, v: attn.attention(
            q, k, v, causal=False, window=0, chunk=cfg.attn_chunk),
            q2, k2, v2, n_kv_heads=cfg.n_kv_heads)
        x = _pin(cfg, x + linear_fwd(p["cross"]["wo"], o2))
    h = norm_fwd(cfg.norm, p["norm2"], x, cfg.norm_eps)
    y, aux = _ffn(p, cfg, h)
    return x + y, aux


def _cross_q(p_cross: dict, cfg: ModelConfig, h: torch.Tensor
             ) -> torch.Tensor:
    """The cross-attention's queries (B, S, H, D)."""
    return attn.project_heads(
        p_cross["wq"], h, cfg.n_heads, cfg.derived_head_dim(),
        ctx.shard_heads(h, cfg.n_heads, cfg.n_kv_heads))


def _cross_kv(p_cross: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention's keys and values of the encoder output
    (B, F, KV, D) each."""
    hd = cfg.derived_head_dim()
    shard = ctx.shard_heads(enc_out, cfg.n_heads, cfg.n_kv_heads)
    return tuple(attn.project_heads(p_cross[w], enc_out, cfg.n_kv_heads, hd,
                                    shard) for w in ("wk", "wv"))


def _init_mamba_block(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    init = ssm.init_mamba1 if cfg.ssm.kind == "mamba1" else ssm.init_mamba2
    return {"norm": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                              device),
            "mixer": init(gen, cfg, cfg.param_dtype, device)}


def _mixer(p: dict, cfg: ModelConfig, h: torch.Tensor,
           state: Optional[dict], decode: bool) -> Tuple[torch.Tensor, dict]:
    """A Mamba mixer's forward (``decode``: one decode step) -> (y, state).
    On a mesh whose "model" axis cuts d_inner (Mamba2: the heads) into
    whole blocks, tensor parallel (`ssm.mixer_tp`: y a partial sum on
    "model", the states handed back in the placements they came in);
    otherwise on each rank's batch block with the mixer's weights
    gathered (the chunked scans run per batch row and channel, outside
    any DTensor operation; the states come back batch-sharded)."""
    m1 = cfg.ssm.kind == "mamba1"
    fn = (ssm.mamba1_decode if m1 else ssm.mamba2_decode) if decode \
        else (ssm.mamba1_fwd if m1 else ssm.mamba2_fwd)
    if not ctx.is_dtensor(h):
        return fn(p, cfg, h, state)
    if "model" in h.device_mesh.mesh_dim_names \
            and ssm.tp_blocks(cfg, ctx.model_size(h)):
        y, new = ssm.mixer_tp(p, cfg, h, state, decode)
        if state is not None:
            new = {k: ctx.placed_as(v, state[k]) for k, v in new.items()}
        return y, new
    return ctx.local(lambda p, h, st: fn(p, cfg, h, st), (p, h, state),
                     [None, {0: "dp"}, {0: "dp"}], ({0: "dp"}, {0: "dp"}))


def _mamba_block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     state: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, dict]:
    x = _pin(cfg, x)
    h = norm_fwd(cfg.norm, p["norm"], x, cfg.norm_eps)
    y, new_state = _mixer(p["mixer"], cfg, h, state, decode=False)
    return _residual(cfg, x, y), new_state


def _mamba_decode_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        state: dict) -> Tuple[torch.Tensor, dict]:
    h = norm_fwd(cfg.norm, p["norm"], x, cfg.norm_eps)
    y, new_state = _mixer(p["mixer"], cfg, h, state, decode=True)
    return _residual(cfg, x, y), new_state


def _residual(cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """x + y pinned, a tensor-parallel mixer's partial sums in y reduced
    by the pin first (DTensor would add a replicated x to a partial sum
    as x / m on each of m ranks)."""
    return _pin(cfg, x + _pin(cfg, y))


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random params from a seeded ``generator`` at the reference's
    scales and dtypes, in the reference's tree (the draws differ from
    `jax.random`'s; tests carry the reference's params across with
    `convert.to_torch`).  A generator on the card draws there, which is
    what a full-size init wants."""
    _check_family(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                cfg.param_dtype, device),
        "final_norm": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.vocab, cfg.d_model,
                                           cfg.param_dtype, device)
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        block = lambda: _init_mamba_block(generator, cfg, device)  # noqa
    else:
        kind = {"moe": "moe", "audio": "dec_cross"}.get(fam, "dense")
        block = lambda: _init_transformer_block(  # noqa: E731
            generator, cfg, device, kind)
    params["blocks"] = _stacked(block, cfg.n_layers)
    if fam == "hybrid":
        params["shared_attn"] = _init_transformer_block(generator, cfg,
                                                        device)
    if fam == "audio":
        params["encoder"] = {
            "blocks": _stacked(lambda: _init_transformer_block(
                generator, cfg, device, "enc"), cfg.encoder_layers),
            "final_norm": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                    device),
        }
    return params


# ---------------------------------------------------------------------------
# Position / rope helpers
# ---------------------------------------------------------------------------

def _angles_for(cfg: ModelConfig, positions: torch.Tensor
                ) -> Optional[torch.Tensor]:
    if cfg.rope_mode == "none":
        return None
    hd = cfg.derived_head_dim()
    if cfg.rope_mode == "mrope":
        # positions (B, S) text-style -> identical t/h/w sections
        p3 = torch.stack([positions, positions, positions])
        return mrope_angles(p3, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(positions, hd, cfg.rope_theta)


def _vlm_angles(cfg: ModelConfig, B: int, P: int, S_text: int,
                device) -> torch.Tensor:
    """M-RoPE ids: patches at t = 0 on the (gh, gw) grid, then text
    linear from max(patch_grid)."""
    gh, gw = cfg.patch_grid
    ar = torch.arange(P, device=device)
    base = int(max(cfg.patch_grid))
    t_t = base + torch.arange(S_text, device=device)
    pos_t = torch.cat([torch.zeros_like(ar), t_t])
    pos_h = torch.cat([ar // gw, t_t])
    pos_w = torch.cat([ar % gw, t_t])
    p3 = torch.stack([pos_t, pos_h, pos_w])[:, None, :].repeat(1, B, 1)
    return mrope_angles(p3, cfg.derived_head_dim(), cfg.rope_theta,
                        cfg.mrope_sections)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].repeat(B, 1)


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict):
    """The residual stream's input and the text's RoPE angles: the token
    embeddings, after the vlm family's patches (whose M-RoPE ids come
    first).  Returns (x, angles, text length)."""
    tokens = batch["tokens"]
    B, S_text = tokens.shape
    cdt = dtype_of(cfg.compute_dtype)
    x = embed_fwd(params["embed"], tokens, cdt)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cdt)
        P = patches.shape[1]
        return (torch.cat([patches, x], dim=1),
                ctx.like(_vlm_angles(cfg, B, P, S_text, x.device), x),
                S_text)
    return x, _like(_angles_for(cfg, _positions(B, S_text, x.device)),
                    x), S_text


def _like(angles: Optional[torch.Tensor], x: torch.Tensor):
    return None if angles is None else ctx.like(angles, x)


def _pin(cfg: ModelConfig, h: torch.Tensor, between: bool = False
         ) -> torch.Tensor:
    """The residual stream's pin: batch on the data axes, replicated on
    "model" (a row-parallel product's partial sums are reduced here).
    ``between`` blocks (the reference's pin) with ``seq_parallel`` the
    sequence goes on "model" instead, and each block gathers it back on
    entry."""
    if not ctx.is_dtensor(h):
        return h
    return ctx.to_layout(h, {0: "dp", 1: "model"}
                         if between and cfg.seq_parallel else {0: "dp"})


def _encode_audio(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  remat: bool = False) -> torch.Tensor:
    """The audio encoder: non-causal blocks over the frames (RoPE over
    the frame index; no K6), then its final norm."""
    B, Fa = frames.shape[:2]
    angles = _like(_angles_for(cfg, _positions(B, Fa, frames.device)),
                   frames)
    enc = params["encoder"]
    body = lambda p, h: _transformer_block_fwd(  # noqa: E731
        p, cfg, h, angles, causal=False, window=0)[0]
    x = _pin(cfg, frames, True)
    for p in _layers(enc["blocks"], cfg.encoder_layers):
        x = _pin(cfg, _block(body, remat, p, x), True)
    return norm_fwd(cfg.norm, enc["final_norm"], x, cfg.norm_eps)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the unembedding, on the stream's batch layout
    (a ``seq_parallel`` sequence gathered back first)."""
    x = norm_fwd(cfg.norm, params["final_norm"], _pin(cfg, x), cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_fwd(head, x)


# ---------------------------------------------------------------------------
# Forward (teacher forcing / scoring)
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, batch: dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits over the text positions (B, S, V) and the MoE aux loss
    summed over the layers (0 for the other families)."""
    _check_family(cfg)
    remat = _trains(params, cfg) and cfg.remat
    x, angles, S_text = _embed_inputs(params, cfg, batch)
    aux = _zero(x)
    if cfg.family in _ATTENTION:
        enc_out = None
        if cfg.family == "audio":
            enc_out = _encode_audio(
                params, cfg, batch["frames"].to(dtype_of(cfg.compute_dtype)),
                remat)
        body = lambda p, h: _transformer_block_fwd(  # noqa: E731
            p, cfg, h, angles, causal=True, window=cfg.sliding_window,
            enc_out=enc_out)
        x = _pin(cfg, x, True)
        for p in _layers(params["blocks"], cfg.n_layers):
            x, a = _block(body, remat, p, x)
            x = _pin(cfg, x, True)
            aux = aux + a
        x = x[:, -S_text:]
    else:
        x = _mamba_forward(params, cfg, x, angles, remat)
    return _head(params, cfg, x), aux


def _hybrid_groups(cfg: ModelConfig):
    """[(start, size), ...] with shared attention after every full group
    (one group of every layer when ``cfg.attn_every`` is 0: the ssm
    family)."""
    per = cfg.attn_every if cfg.attn_every else cfg.n_layers
    groups = []
    i = 0
    while i < cfg.n_layers:
        size = min(per, cfg.n_layers - i)
        groups.append((i, size))
        i += size
    return groups


def _attn_after(cfg: ModelConfig, start: int, size: int) -> bool:
    """Whether the shared attention block runs after a group."""
    return bool(cfg.attn_every) and (start + size) % cfg.attn_every == 0


def _mamba_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                   angles, remat: bool) -> torch.Tensor:
    """The ssm and hybrid stacks: the Mamba blocks group by group, the
    hybrid family's shared attention block after each full group (a
    dense block: its aux loss is 0)."""
    body = lambda p, h: _mamba_block_fwd(p, cfg, h)[0]  # noqa: E731
    layers = _layers(params["blocks"], cfg.n_layers)
    x = _pin(cfg, x, True)
    for start, size in _hybrid_groups(cfg):
        for p in layers[start:start + size]:
            x = _pin(cfg, _block(body, remat, p, x), True)
        if _attn_after(cfg, start, size):
            x = _pin(cfg, _transformer_block_fwd(
                params["shared_attn"], cfg, x, angles, causal=True,
                window=cfg.sliding_window)[0], True)
    return x


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(params: dict, cfg: ModelConfig, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    logits, aux = forward(params, cfg, batch)
    # on a mesh the loss reads whole rows: vocab gathered, batch on dp
    logits = ctx.to_layout(logits, {0: "dp"})
    targets = batch["targets"].long()
    mask = batch.get("loss_mask")
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    ce = nll.sum() / denom
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    loss = ce + aux_w * aux / max(cfg.n_layers, 1)
    acc = logits.argmax(-1) == targets
    if mask is not None:
        acc = (acc * mask).sum() / denom
    else:
        acc = acc.to(torch.float32).mean()
    return loss, {"ce": ce, "aux": aux, "accuracy": acc}


# ---------------------------------------------------------------------------
# KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """The KV cache of every attention layer ("kv"), and for the audio
    family every decoder layer's cross keys and values over the
    ``n_audio_frames`` encoder outputs ("cross", filled by `prefill`);
    for the ssm and hybrid families the float32 SSM state of every layer
    ("ssm") and, for the hybrid family, one KV slot per shared-attention
    call ("attn")."""
    _check_family(cfg)
    hd = cfg.derived_head_dim()
    C = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(n: int, length: int) -> torch.Tensor:
        return torch.zeros((n, batch, length, cfg.n_kv_heads, hd),
                           dtype=dtype, device=device)

    def kv_stack(n: int) -> dict:
        return {"k": zeros(n, C), "v": zeros(n, C),
                "idx": torch.zeros(n, dtype=torch.int32, device=device)}

    if cfg.family in _ATTENTION:
        cache["kv"] = kv_stack(cfg.n_layers)
        if cfg.family == "audio":
            cache["cross"] = {"k": zeros(cfg.n_layers, cfg.n_audio_frames),
                              "v": zeros(cfg.n_layers, cfg.n_audio_frames)}
        return cache
    init = ssm.init_mamba1_state if cfg.family == "ssm" \
        else ssm.init_mamba2_state
    cache["ssm"] = tree_util.map(
        lambda a: torch.zeros((cfg.n_layers,) + tuple(a.shape),
                              dtype=a.dtype, device=device),
        init(cfg, batch, device))
    if cfg.family == "hybrid":
        n_attn = sum(1 for s, z in _hybrid_groups(cfg)
                     if _attn_after(cfg, s, z))
        cache["attn"] = kv_stack(max(n_attn, 1))
    return cache


def _attn_block_with_cache(p, cfg: ModelConfig, x, angles, cache_layer,
                           cross_cache=None, decode=False):
    """Runs one transformer block, reading/writing the layer KV cache;
    with ``cross_cache`` (the layer's cross keys and values) it
    cross-attends to the encoder output.  Returns (x, cache_layer)."""
    hd = cfg.derived_head_dim()
    S = x.shape[1]
    h = norm_fwd(cfg.norm, p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, hd)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    idx = cache_layer["idx"]

    def attend(q, k, v, ck, cv):
        layer = attn.cache_write({"k": ck, "v": cv, "idx": idx}, k, v)
        if decode:
            o = attn.decode_attend(q, layer, window=cfg.sliding_window)
        else:
            o = attn.attention(q, k, v, causal=True,
                               window=cfg.sliding_window,
                               chunk=cfg.attn_chunk)
        return o, layer["k"], layer["v"]

    # on a mesh the layer's cache slot is read and written in the
    # attention's (batch, heads) layout, then stored back in its own
    o, ck, cv = attn.local_heads(attend, q, k, v, cache_layer["k"],
                                 cache_layer["v"],
                                 n_kv_heads=cfg.n_kv_heads)
    if ck is not cache_layer["k"] and not ctx.same_placement(
            ck, cache_layer["k"]):      # else written in place already
        ctx.write(cache_layer["k"], ck)
        ctx.write(cache_layer["v"], cv)
    cache_layer = dict(cache_layer, idx=idx + S)
    x = _pin(cfg, x + linear_fwd(p["attn"]["wo"], o))
    if cross_cache is not None:
        h = norm_fwd(cfg.norm, p["norm_x"], x, cfg.norm_eps)
        q2 = _cross_q(p["cross"], cfg, h)
        kc, vc = cross_cache["k"], cross_cache["v"]
        if decode:      # read as cached (float32 under launch.serve)
            o2 = attn.local_heads(lambda q, k, v: attn.decode_attend(q, {
                "k": k, "v": v,
                "idx": torch.tensor(k.shape[1], dtype=torch.int32,
                                    device=k.device)}), q2, kc, vc,
                n_kv_heads=cfg.n_kv_heads)
        else:
            o2 = attn.local_heads(lambda q, k, v: attn.attention(
                q, k.to(q.dtype), v.to(q.dtype), causal=False,
                chunk=cfg.attn_chunk), q2, kc, vc,
                n_kv_heads=cfg.n_kv_heads)
        x = _pin(cfg, x + linear_fwd(p["cross"]["wo"], o2))
    h = norm_fwd(cfg.norm, p["norm2"], x, cfg.norm_eps)
    y, _ = _ffn(p, cfg, h)
    return _pin(cfg, x + y), cache_layer


def _attn_slot(p: dict, cfg: ModelConfig, x: torch.Tensor, angles,
               kv: dict, i: int, decode: bool,
               cross: Optional[dict] = None) -> torch.Tensor:
    """One attention block over slot ``i`` of a stacked KV cache (k and v
    written in place, the slot's token count updated), and over slot
    ``i`` of the cross cache when there is one."""
    layer = {"k": kv["k"][i], "v": kv["v"][i], "idx": kv["idx"][i]}
    cross_layer = None if cross is None else {"k": cross["k"][i],
                                              "v": cross["v"][i]}
    x, layer = _attn_block_with_cache(p, cfg, x, angles, layer,
                                      cross_cache=cross_layer,
                                      decode=decode)
    kv["idx"][i] = layer["idx"]
    return x


def _run_cached(params: dict, cfg: ModelConfig, x: torch.Tensor,
                angles, cache: dict, decode: bool) -> torch.Tensor:
    """Every layer over its cache: the attention layers' KV slots (and
    the audio family's cross slots), or the Mamba layers' states
    (replaced) and the hybrid family's shared attention slots."""
    if cfg.family in _ATTENTION:
        for i in range(cfg.n_layers):
            x = _attn_slot(_layer(params["blocks"], i), cfg, x, angles,
                           cache["kv"], i, decode, cache.get("cross"))
        return x
    block = _mamba_decode_block if decode else _mamba_block_fwd
    states = []
    ai = 0
    for start, size in _hybrid_groups(cfg):
        for i in range(start, start + size):
            x, st = block(_layer(params["blocks"], i), cfg, x,
                          _layer(cache["ssm"], i))
            states.append(st)
        if _attn_after(cfg, start, size):
            x = _attn_slot(params["shared_attn"], cfg, x, angles,
                           cache["attn"], ai, decode)
            ai += 1
    # torch.stack promotes mixed layer dtypes as jnp's concatenate does
    cache["ssm"] = tree_util.map(lambda *xs: torch.stack(xs), *states)
    return x


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict
            ) -> Tuple[torch.Tensor, dict]:
    """Consume the prompt (after the vlm family's patches), fill the
    cache (the audio family's cross keys and values of every layer
    first), return the last-position logits (B, 1, V)."""
    _check_family(cfg)
    x, angles, _ = _embed_inputs(params, cfg, batch)
    if cfg.family == "audio":
        enc_out = _encode_audio(
            params, cfg, batch["frames"].to(dtype_of(cfg.compute_dtype)))
        cross = cache["cross"]
        for i in range(cfg.n_layers):
            k2, v2 = _cross_kv(_layer(params["blocks"], i)["cross"], cfg,
                               enc_out)
            ctx.write(cross["k"][i], k2)
            ctx.write(cross["v"][i], v2)
    x = _run_cached(params, cfg, x, angles, cache, decode=False)
    cache["pos"] = cache["pos"] + x.shape[1]
    return _head(params, cfg, x[:, -1:]), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """tokens (B, 1) -> (logits (B, 1, V), cache updated)."""
    _check_family(cfg)
    x = embed_fwd(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    B = x.shape[0]
    pos = cache["pos"][None].repeat(B)[:, None]                   # (B, 1)
    if cfg.family == "vlm":
        # text rope position: patches occupy grid positions, text restarts
        # at max(patch_grid) (M-RoPE); cache["pos"] counts patches + text
        pos = pos - cfg.n_patches + int(max(cfg.patch_grid))
    angles = _like(_angles_for(cfg, pos), x)
    x = _run_cached(params, cfg, x, angles, cache, decode=True)
    cache["pos"] = cache["pos"] + 1
    return _head(params, cfg, x), cache
