"""Mixture-of-Experts FFN with capacity-based dispatch.

Port of `repro.models.moe`, step for step:

  1. top-k routing over softmax(router logits), ties broken towards the
     lower expert index as `jax.lax.top_k` breaks them;
  2. the rank of each assignment within its expert, from a stable sort;
  3. an add of the tokens into a zeroed (E, C, d) buffer, assignments at
     rank C or later dropped;
  4. the grouped expert products 'ecd,edf->ecf' (batched matmuls);
  5. a gather back at min(rank, C − 1), times keep = rank < C, combined
     with the top-k gate weights, plus the shared expert.

A Switch-style load-balance loss is returned alongside.  The buffer's
sharding is pinned between the steps as the reference pins it
(`sharding.ctx.constrain_axis`, a no-op on one device).  The sort, scatter and gather are XLA ops in the
reference, outside any Pallas kernel, and plain PyTorch here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..sharding import ctx
from .config import ModelConfig
from .layers import (dtype_of, init_linear, init_mlp, linear_fwd, mlp_fwd,
                     normal, silu)

# Expert weights cast to another dtype (a bfloat16 model over serving's
# float32 stream) are cast this many elements at a time, so no float32
# copy of a whole (E, d, f) leaf is made: kimi-k2's would be 22.5 GB.
_CAST_ELEMENTS = 1 << 28


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: str = "float32",
             device="cpu") -> dict:
    """The reference's tree and scales: a router (d, E) at 0.02, three
    (E, ·, ·) expert leaves at 1/√fan-in, and the shared expert, an MLP
    of width d_expert · n_shared.  Each expert's weights are drawn in
    float32 and cast straight into the leaf, so a full-width init holds
    one expert's float32 draws at a time (the draws differ from
    `jax.random`'s; tests carry the reference's params across)."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_expert

    def ew(a: int, b: int) -> torch.Tensor:
        w = torch.empty((E, a, b), dtype=dtype_of(dtype), device=device)
        for e in range(E):
            w[e] = normal(gen, (a, b), device) / math.sqrt(a)
        return w

    p = {
        "router": init_linear(gen, d, E, dtype=dtype, scale=0.02,
                              device=device),
        "w_gate": ew(d, f),
        "w_up": ew(d, f),
        "w_down": ew(f, d),
    }
    if m.n_shared:
        p["shared"] = init_mlp(gen, d, f * m.n_shared, kind=cfg.mlp,
                               dtype=dtype, device=device)
    return p


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values and their
    indices, equal values in order of index.  `torch.topk` promises no
    order among ties, and a bfloat16 router's logits tie often."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert, int64 (E,): `torch.bincount` with its
    length taken from the config, so the shape never depends on the
    routing (the reference's host arithmetic fixes it the same way)."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int64))


def positions_in_expert(flat_e: torch.Tensor, n_experts: int
                        ) -> torch.Tensor:
    """Rank of each assignment within its expert, in assignment order
    (the reference's `_positions_in_expert`): int32."""
    order = torch.argsort(flat_e, stable=True)
    counts = expert_counts(flat_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device) \
        - starts[flat_e[order]]
    return pos.to(torch.int32)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: the reference's host arithmetic,
    max(min_capacity, int(T·K/E·capacity_factor)) in Python floats."""
    m = cfg.moe
    return max(m.min_capacity,
               int(T * m.top_k / m.n_experts * m.capacity_factor))


def _grouped(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'ecd,edf->ecf' with ``w`` cast to ``a``'s dtype, the cast made a
    group of experts at a time when it copies."""
    if w.dtype == a.dtype:
        return torch.bmm(a, w)
    step = max(1, _CAST_ELEMENTS // w[0].numel())
    return torch.cat([torch.bmm(a[e:e + step], w[e:e + step].to(a.dtype))
                      for e in range(0, w.shape[0], step)])


def _route(cfg: ModelConfig, logits: torch.Tensor, dtype: torch.dtype):
    """Top-k routing of every token's (T, E) float32 logits: the gate
    weights (T, K) in ``dtype``, the assignments' experts (T·K,), ranks in
    their experts, keep flags, buffer slots (a dropped assignment goes to
    one scrap row past the buffer, so no host sync picks the kept ones
    out), and the load-balance loss."""
    m = cfg.moe
    T = logits.shape[0]
    E, K = m.n_experts, m.top_k
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, K)                                    # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gate = gate.to(dtype)

    # Switch load-balance loss: E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)                                  # (E,)
    flat_e = idx.reshape(T * K)
    ce = expert_counts(flat_e, E).to(torch.float32) / (T * K)
    aux = E * torch.sum(me * ce)

    C = capacity(cfg, T)
    pos = positions_in_expert(flat_e, E)                           # (T*K,)
    keep_b = pos < C
    slot = torch.where(keep_b, flat_e * C + pos, E * C)
    return gate, flat_e, pos, keep_b, slot, aux


def _dispatch(xf: torch.Tensor, slot: torch.Tensor, E: int, C: int,
              K: int) -> torch.Tensor:
    """The add of every assignment's token into a zeroed (E, C, d)
    buffer (the scrap row dropped)."""
    xrep = torch.repeat_interleave(xf, K, dim=0)                   # (T*K, d)
    buf = torch.zeros((E * C + 1, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device)
    buf.index_add_(0, slot, xrep)
    return buf[:E * C].view(E, C, xf.shape[1])


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The grouped expert products 'ecd,edf->ecf' -> (E, C, d)."""
    h_g = _grouped(buf, w_gate)
    h_u = _grouped(buf, w_up)
    return _grouped(silu(h_g) * h_u, w_down)


def _combine(y_buf: torch.Tensor, flat_e, pos, keep_b, gate) -> torch.Tensor:
    """The gather back at min(rank, C − 1); dropped assignments contribute
    y · 0; the top-k sum weighted by the gate -> (T, d)."""
    C, d = y_buf.shape[1:]
    keep = keep_b.to(y_buf.dtype)
    out_rep = y_buf[flat_e, torch.clamp(pos, max=C - 1).long()] \
        * keep[:, None]
    T, K = gate.shape
    return (out_rep.reshape(T, K, d) * gate[..., None]).sum(dim=1)


def moe_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar).

    On a mesh (DTensor ``x``) the routing runs replicated over every
    token, as capacity and ranks are global; the buffer is filled with
    its d dim on "model", re-sharded expert-major for the products, and
    back to d-major for the combine: the reference's three pins
    (`sharding.ctx.constrain_axis`)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = capacity(cfg, T)
    xf = x.reshape(T, d)

    logits = linear_fwd(p["router"], xf).to(torch.float32)         # (T, E)
    gate, flat_e, pos, keep_b, slot, aux = ctx.local(
        lambda lg: _route(cfg, lg, x.dtype), (logits,), [None], None)

    buf = ctx.local(lambda xf, sl: _dispatch(xf, sl, E, C, K), (xf, slot),
                    [{1: "model"}, None], {2: "model"})
    buf = ctx.constrain_axis(buf, 0, "model")
    ws = [ctx.weight(p[k]) for k in ("w_gate", "w_up", "w_down")]
    y_buf = ctx.local(_experts, [buf] + ws, [{0: "model"}] * 4,
                      {0: "model"})
    y_buf = ctx.constrain_axis(y_buf, 2, "model")
    out = ctx.local(_combine, (y_buf, flat_e, pos, keep_b, gate),
                    [{2: "model"}, None, None, None, None], {1: "model"})
    out = ctx.constrain_batch(out.reshape(B, S, d), 0)

    if "shared" in p:
        out = out + mlp_fwd(cfg.mlp, p["shared"], x)
    return out, aux
