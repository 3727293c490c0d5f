"""The model zoo's decoder: dense, ssm and hybrid families.

Port of `repro.models.model` for ``cfg.family`` "dense" (smollm-360m,
qwen1.5-0.5b, olmo-1b, codeqwen1.5-7b), "ssm" (falcon-mamba-7b: a stack
of Mamba1 blocks) and "hybrid" (zamba2-1.2b: Mamba2 blocks with one
shared attention block after every ``cfg.attn_every`` of them).  Public
API, as the reference's:

  init_params(cfg, generator, device)              -> params
  forward(params, cfg, batch)                      -> (logits, aux_loss)
  loss_fn(params, cfg, batch)                      -> (loss, metrics)
  init_cache(cfg, batch, cache_len, dtype, device) -> cache
  prefill(params, cfg, batch, cache)               -> (logits, cache)
  decode_step(params, cfg, tokens, cache)          -> (logits, cache)

Params keep the reference's stacked layout: every leaf of
``params["blocks"]`` has a leading n_layers axis, so `convert.to_torch`
carries a JAX param tree across as it is.  The reference scans the layer
stack; here a Python loop walks it.  With ``cfg.use_flash`` every causal
self-attention of `forward` (the dense blocks, zamba2's shared block)
runs kernel K6 (`kernels.ops.attention_pallas`); `prefill` and
`decode_step` use `models.attention`, as the reference does.  The Mamba
blocks run the reference's chunked scans (`models.ssm`), which call
neither K7 nor K8, as in the reference.  ``remat`` and ``seq_parallel``
change no forward value and are ignored.

Serving with a float32 cache under a bfloat16 model (what
`launch.serve` does) promotes as jnp does: a decode attention reads
float32 keys, so its output and from there the residual stream are
float32 (every dense layer; zamba2 after its first shared block; never
falcon-mamba, whose float32 SSM state is cast back to the stream's
dtype).  The reference's scanned dense `decode_step` refuses that change
of carry dtype; its blocks, called one by one, compute what the loop
here computes.  The SSM states are replaced by each prefill and decode
step (stacked per layer, promoted as jnp's concatenate does), so the
conv state takes the stream's dtype as in the reference; the KV caches
are written in place.

The moe, vlm and audio families load their configs, and every function
here raises `NotImplementedError` on them naming the ROADMAP.md item
that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree as tree_util
from ..kernels.ops import attention_pallas
from . import attention as attn
from . import ssm
from .config import ModelConfig
from .layers import (apply_rope, dtype_of, embed_fwd, init_embedding,
                     init_mlp, init_norm, linear_fwd, mlp_fwd, norm_fwd,
                     rope_angles, unembed_fwd)

_PORTED = ("dense", "ssm", "hybrid")
_LATER = {"moe": "16c", "vlm": "16c", "audio": "16c"}


def _require_ported(cfg: ModelConfig, what: str) -> None:
    if cfg.family in _PORTED:
        return
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family ({cfg.name}) is not ported "
            f"to repro_torch yet (ROADMAP.md item {_LATER[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family}")


def _layer(blocks: dict, i: int) -> dict:
    return tree_util.map(lambda a: a[i], blocks)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_transformer_block(gen: torch.Generator, cfg: ModelConfig,
                            device) -> dict:
    """A dense block (the reference's kind "dense")."""
    hd = cfg.derived_head_dim()
    dt = cfg.param_dtype
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, dt, device),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, cfg.qkv_bias, dt,
                                    device),
        "norm2": init_norm(cfg.norm, cfg.d_model, dt, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt, device),
    }


def _transformer_block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           angles: Optional[torch.Tensor], *, causal: bool,
                           window: int) -> torch.Tensor:
    """One dense block; the reference also returns its MoE aux loss, which
    is 0 for a dense block."""
    hd = cfg.derived_head_dim()
    h = norm_fwd(cfg.norm, p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, hd)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    if cfg.use_flash and causal:
        o = attention_pallas(q, k, v, causal=True, window=window)
    else:
        o = attn.attention(q, k, v, causal=causal, window=window,
                           chunk=cfg.attn_chunk)
    B, S = x.shape[:2]
    x = x + linear_fwd(p["attn"]["wo"], o.reshape(B, S, -1))
    h = norm_fwd(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + mlp_fwd(cfg.mlp, p["mlp"], h)


def _init_mamba_block(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    init = ssm.init_mamba1 if cfg.ssm.kind == "mamba1" else ssm.init_mamba2
    return {"norm": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                              device),
            "mixer": init(gen, cfg, cfg.param_dtype, device)}


def _mamba_block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     state: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, dict]:
    h = norm_fwd(cfg.norm, p["norm"], x, cfg.norm_eps)
    fwd = ssm.mamba1_fwd if cfg.ssm.kind == "mamba1" else ssm.mamba2_fwd
    y, new_state = fwd(p["mixer"], cfg, h, state)
    return x + y, new_state


def _mamba_decode_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        state: dict) -> Tuple[torch.Tensor, dict]:
    h = norm_fwd(cfg.norm, p["norm"], x, cfg.norm_eps)
    dec = ssm.mamba1_decode if cfg.ssm.kind == "mamba1" \
        else ssm.mamba2_decode
    y, new_state = dec(p["mixer"], cfg, h, state)
    return x + y, new_state


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random params from a seeded ``generator`` at the reference's
    scales and dtypes (the draws differ from `jax.random`'s; tests carry
    the reference's params across with `convert.to_torch`).  A generator
    on the card draws there, which is what a full-size init wants."""
    _require_ported(cfg, "init_params")
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                cfg.param_dtype, device),
        "final_norm": init_norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.vocab, cfg.d_model,
                                           cfg.param_dtype, device)
    block = _init_transformer_block if cfg.family == "dense" \
        else _init_mamba_block
    layers = [block(generator, cfg, device) for _ in range(cfg.n_layers)]
    params["blocks"] = tree_util.map(lambda *xs: torch.stack(xs), *layers)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_transformer_block(generator, cfg,
                                                        device)
    return params


# ---------------------------------------------------------------------------
# Position / rope helpers
# ---------------------------------------------------------------------------

def _angles_for(cfg: ModelConfig, positions: torch.Tensor
                ) -> Optional[torch.Tensor]:
    if cfg.rope_mode == "none":
        return None
    if cfg.rope_mode == "mrope":
        raise NotImplementedError("M-RoPE positions come with the vlm "
                                  "family (ROADMAP.md item 16c)")
    return rope_angles(positions, cfg.derived_head_dim(), cfg.rope_theta)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].repeat(B, 1)


# ---------------------------------------------------------------------------
# Forward (teacher forcing / scoring)
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, batch: dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _require_ported(cfg, "forward")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_fwd(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    if cfg.family == "dense":
        angles = _angles_for(cfg, _positions(B, S, x.device))
        for i in range(cfg.n_layers):
            x = _transformer_block_fwd(_layer(params["blocks"], i), cfg, x,
                                       angles, causal=True,
                                       window=cfg.sliding_window)
    else:
        x = _mamba_forward(params, cfg, x)
    x = norm_fwd(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed_fwd(head, x), aux


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


def _mamba_forward(params: dict, cfg: ModelConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """The ssm and hybrid stacks: the Mamba blocks group by group, the
    hybrid family's shared attention block after each full group."""
    B, S = x.shape[:2]
    angles = _angles_for(cfg, _positions(B, S, x.device))
    for start, size in _hybrid_groups(cfg):
        for i in range(start, start + size):
            x = _mamba_block_fwd(_layer(params["blocks"], i), cfg, x)[0]
        if _attn_after(cfg, start, size):
            x = _transformer_block_fwd(params["shared_attn"], cfg, x,
                                       angles, causal=True,
                                       window=cfg.sliding_window)
    return x


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(params: dict, cfg: ModelConfig, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    logits, aux = forward(params, cfg, batch)
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
    """The KV cache of every dense layer ("kv"); for the ssm and hybrid
    families the float32 SSM state of every layer ("ssm") and, for the
    hybrid family, one KV slot per shared-attention call ("attn")."""
    _require_ported(cfg, "init_cache")
    hd = cfg.derived_head_dim()
    C = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def kv_stack(n: int) -> dict:
        shape = (n, batch, C, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "idx": torch.zeros(n, dtype=torch.int32, device=device)}

    if cfg.family == "dense":
        cache["kv"] = kv_stack(cfg.n_layers)
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
                           decode=False):
    """Runs one transformer block, reading/writing the layer KV cache."""
    hd = cfg.derived_head_dim()
    B, S = x.shape[:2]
    h = norm_fwd(cfg.norm, p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads, hd)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    cache_layer = attn.cache_write(cache_layer, k, v)
    if decode:
        o = attn.decode_attend(q, cache_layer, window=cfg.sliding_window)
    else:
        o = attn.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           chunk=cfg.attn_chunk)
    x = x + linear_fwd(p["attn"]["wo"], o.reshape(B, S, -1))
    h = norm_fwd(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + mlp_fwd(cfg.mlp, p["mlp"], h), cache_layer


def _attn_slot(p: dict, cfg: ModelConfig, x: torch.Tensor, angles,
               kv: dict, i: int, decode: bool) -> torch.Tensor:
    """One attention block over slot ``i`` of a stacked KV cache (k and v
    written in place, the slot's token count updated)."""
    layer = {"k": kv["k"][i], "v": kv["v"][i], "idx": kv["idx"][i]}
    x, layer = _attn_block_with_cache(p, cfg, x, angles, layer,
                                      decode=decode)
    kv["idx"][i] = layer["idx"]
    return x


def _run_cached(params: dict, cfg: ModelConfig, x: torch.Tensor,
                angles, cache: dict, decode: bool) -> torch.Tensor:
    """Every layer over its cache: the dense layers' KV slots, or the
    Mamba layers' states (replaced) and the hybrid family's shared
    attention slots."""
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            x = _attn_slot(_layer(params["blocks"], i), cfg, x, angles,
                           cache["kv"], i, decode)
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
    """Consume the prompt, fill the cache, return the last-position
    logits (B, 1, V)."""
    _require_ported(cfg, "prefill")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_fwd(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    angles = _angles_for(cfg, _positions(B, S, x.device))
    x = _run_cached(params, cfg, x, angles, cache, decode=False)
    cache["pos"] = cache["pos"] + S
    x = norm_fwd(cfg.norm, params["final_norm"], x[:, -1:], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_fwd(head, x), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """tokens (B, 1) -> (logits (B, 1, V), cache updated)."""
    _require_ported(cfg, "decode_step")
    x = embed_fwd(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    B = x.shape[0]
    pos = cache["pos"][None].repeat(B)[:, None]                   # (B, 1)
    angles = _angles_for(cfg, pos)
    x = _run_cached(params, cfg, x, angles, cache, decode=True)
    cache["pos"] = cache["pos"] + 1
    x = norm_fwd(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_fwd(head, x), cache
