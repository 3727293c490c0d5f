"""GQA attention: blocked (q-chunked) softmax, KV cache, one-token decode.

Port of `repro.models.attention`, in plain PyTorch: the reference computes
all of this outside any Pallas kernel (the flash kernel K6 is reached from
`models.model` when ``cfg.use_flash``).  Layouts are the reference's:
q (B, S, H, D), k/v (B, S, KV, D), head h reading KV head h // (H // KV).

jnp promotes mixed dtypes where `torch.matmul`/`einsum` refuse them, so
each product here casts both operands to their promoted dtype first.  That
is what happens in serving, where the KV cache is float32 under a bfloat16
model: the decode scores and the probabilities' product with v are then
float32, as in the reference.

The KV cache is updated in place (`index_copy_` into k and v) instead of
returning a copy; `cache_write` still returns the cache.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..sharding import ctx
from .layers import init_linear, linear_fwd

NEG_INF = -1e30


def _promoted(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _sqrt_d(d: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                   device=device))


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool = False,
                   dtype: str = "float32", device="cpu") -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim, bias=qkv_bias,
                          **kw),
        "wk": init_linear(gen, d_model, n_kv_heads * head_dim,
                          bias=qkv_bias, **kw),
        "wv": init_linear(gen, d_model, n_kv_heads * head_dim,
                          bias=qkv_bias, **kw),
        "wo": init_linear(gen, n_heads * head_dim, d_model, **kw),
    }


def qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
        head_dim: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    shard = ctx.shard_heads(x, n_heads, n_kv_heads)
    return (project_heads(p["wq"], x, n_heads, head_dim, shard),
            project_heads(p["wk"], x, n_kv_heads, head_dim, shard),
            project_heads(p["wv"], x, n_kv_heads, head_dim, shard))


def project_heads(p: dict, x: torch.Tensor, n: int, head_dim: int,
                  shard: bool) -> torch.Tensor:
    """(B, S, d) -> (B, S, n, head_dim) through the linear ``p``; on a
    mesh the projection is first put in the layout its head view needs
    (`sharding.ctx.heads`)."""
    B, S = x.shape[:2]
    return ctx.heads(linear_fwd(p, x), shard).reshape(B, S, n, head_dim)


def local_heads(fn, q: torch.Tensor, *kv, n_kv_heads: int):
    """``fn(q, *kv)`` for (B, S, heads, D) operands, its first output
    (B, S, H, D) flattened to (B, S, H·D).  On a mesh, on each rank's
    (batch, heads) block: batch on the data axes, heads on "model" when
    whole heads and GQA groups split over it, else replicated there; the
    outputs come back in that layout (the flattened heads on "model"),
    since DTensor cannot reshape a dim whose shards cut a head."""
    def run(*args):
        out = fn(*args)
        first = out[0] if isinstance(out, tuple) else out
        flat = first.reshape(first.shape[0], first.shape[1], -1)
        return (flat,) + tuple(out[1:]) if isinstance(out, tuple) else flat

    if not ctx.is_dtensor(q):
        return run(q, *kv)
    shard = ctx.shard_heads(q, q.shape[2], n_kv_heads)
    lay = {0: "dp", 2: "model"} if shard else {0: "dp"}
    return ctx.local(run, (q,) + kv, [lay] * (1 + len(kv)), lay)


# ---------------------------------------------------------------------------
# Blocked multi-query attention core
# ---------------------------------------------------------------------------

def _attend_chunk(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                  window: int) -> torch.Tensor:
    """qc (B, C, H, D); k, v (B, Sk, KV, D); qpos (C,), kpos (Sk,).
    Scores in the inputs' (promoted) dtype, then float32; probabilities
    cast back to q's dtype before the product with v."""
    B, C, H, D = qc.shape
    KV = k.shape[2]
    G = H // KV
    qg, kk = _promoted(qc.reshape(B, C, KV, G, D), k)
    scores = torch.einsum("bckgd,bskd->bkgcs", qg, kk).to(torch.float32)
    scores = scores / _sqrt_d(D, qc.device)
    mask = torch.ones((C, k.shape[1]), dtype=torch.bool, device=qc.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask[None, None, None], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=qc.device))
    probs = torch.softmax(scores, dim=-1).to(qc.dtype)
    pp, vv = _promoted(probs, v)
    out = torch.einsum("bkgcs,bskd->bckgd", pp, vv)
    return out.reshape(B, C, H, D)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              chunk: int = 512) -> torch.Tensor:
    """Full attention over (possibly long) sequences, q-chunked.

    q (B, Sq, H, D); k, v (B, Sk, KV, D) with H % KV == 0.  Returns
    (B, Sq, H, D).  The reference's three branches, in its order:
    Sq ≤ chunk attends in one piece; causal with no window or offset and
    Sq == Sk runs the unrolled causal-skip loop (chunk i reads keys
    [0 : (i+1)·chunk], the chunk doubled until at most 16 blocks remain);
    every other case (windows, offsets) walks q-chunks against all keys.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    kpos = torch.arange(Sk, device=dev)
    if Sq <= chunk:
        qpos = q_offset + torch.arange(Sq, device=dev)
        return _attend_chunk(q, k, v, qpos, kpos, causal, window)

    if causal and window == 0 and q_offset == 0 and Sq == Sk:
        chunk_u = chunk
        while -(-Sq // chunk_u) > 16:
            chunk_u *= 2
        n_u = -(-Sq // chunk_u)
        qp = F.pad(q, (0, 0, 0, 0, 0, n_u * chunk_u - Sq))
        qp4 = qp.reshape(B, n_u, chunk_u, H, D)
        outs = []
        for i in range(n_u):
            hi = min((i + 1) * chunk_u, Sk)
            qpos = i * chunk_u + torch.arange(chunk_u, device=dev)
            outs.append(_attend_chunk(qp4[:, i], k[:, :hi], v[:, :hi], qpos,
                                      kpos[:hi], True, 0))
        return torch.cat(outs, dim=1)[:, :Sq]

    n = -(-Sq // chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, n * chunk - Sq))
    qp = qp.reshape(B, n, chunk, H, D)
    outs = []
    for i in range(n):
        qpos = q_offset + i * chunk + torch.arange(chunk, device=dev)
        outs.append(_attend_chunk(qp[:, i], k, v, qpos, kpos, causal,
                                  window))
    return torch.cat(outs, dim=1)[:, :Sq]


# ---------------------------------------------------------------------------
# KV cache (supports ring-buffer sliding window)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device="cpu") -> dict:
    shape = (batch, cache_len, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # number of tokens written so far (0-d int32)
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor
                ) -> dict:
    """Append S_new tokens in place; the ring buffer wraps when the cache
    is full.  When S_new exceeds the cache length only the last C tokens
    are written: the reference's scatter writes the slots in order, so
    those are the ones that stay.  The slot indices are computed on the
    device, so a write never waits for the host."""
    C = cache["k"].shape[1]
    S_new = k_new.shape[1]
    skip = max(S_new - C, 0)
    n = S_new - skip
    start = torch.remainder(cache["idx"].to(torch.int64) + skip, C)
    idxs = torch.remainder(start + torch.arange(n, device=start.device), C)
    cache["k"].index_copy_(1, idxs, k_new[:, skip:].to(cache["k"].dtype))
    cache["v"].index_copy_(1, idxs, v_new[:, skip:].to(cache["v"].dtype))
    cache["idx"] = cache["idx"] + S_new
    return cache


def decode_attend(q: torch.Tensor, cache: dict, *, window: int = 0
                  ) -> torch.Tensor:
    """One-token attention against the cache.  q (B, 1, H, D) ->
    (B, 1, H, D), in the promoted dtype of q and the cache.

    All cached entries are in the past, so no ordering mask is needed
    beyond validity; sliding windows are enforced by the ring buffer size
    itself (cache_len == window) plus the validity mask.
    """
    B, _, H, D = q.shape
    k, v, idx = cache["k"], cache["v"], cache["idx"]
    C = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    qg, kk = _promoted(q.reshape(B, KV, G, D), k)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kk).to(torch.float32)
    scores = scores / _sqrt_d(D, q.device)
    valid = torch.arange(C, device=q.device) < torch.clamp(idx, max=C)
    scores = torch.where(valid[None, None, None], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    pp, vv = _promoted(probs, v)
    out = torch.einsum("bkgs,bskd->bkgd", pp, vv)
    return out.reshape(B, 1, H, D)
