"""Primitive layers: linear, norms, rotary embeddings, MLPs, embeddings.

Port of `repro.models.layers`, on nested dicts of tensors with the
reference's keys and layouts (a linear weight is (d_in, d_out)).  Every
cast the reference makes is made here in the same place: a linear casts
its weight to the activation's dtype, a norm computes in float32 and
casts back, RoPE casts cos/sin to the activation's dtype.  Init draws
from a `torch.Generator` at the reference's scales (the numbers differ
from `jax.random`'s; tests carry reference params across with
`convert.to_torch`).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.async_update import _libm_powf
from ..sharding import ctx


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    return getattr(torch, name)


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` (on ``gen``'s device),
    moved to ``device``."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32).to(device)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype: str = "float32",
                scale: Optional[float] = None, device="cpu") -> dict:
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    p = {"w": (normal(gen, (d_in, d_out), device) * scale)
         .to(dtype_of(dtype))}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype_of(dtype), device=device)
    return p


def linear_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ ctx.weight(p["w"]).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, dtype: str = "float32",
              device="cpu") -> dict:
    dt = dtype_of(dtype)
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dt, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=dt, device=device),
                "bias": torch.zeros(d, dtype=dt, device=device)}
    if kind == "nonparam_ln":   # OLMo-style non-parametric LayerNorm
        return {}
    raise ValueError(f"unknown norm kind {kind!r}")


def norm_fwd(kind: str, p: dict, x: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        return (y * p["scale"].to(torch.float32)).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    ex = np.arange(0, half, dtype=np.float32) / np.float32(half)
    powf = _libm_powf()
    th = float(np.float32(theta))
    den = np.array([powf(th, float(e)) for e in ex], dtype=np.float32)
    return np.float32(1.0) / den


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), float32.  The powers are
    taken on the host with the C library's ``powf``, the call XLA's CPU
    backend makes for a float32 power (see `core.async_update`)."""
    return torch.tensor(_inv_freqs(head_dim, float(theta)), device=device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE: positions3 (3, B, S) (t, h, w ids) -> (B, S, head_dim//2).

    The half-dim is split into contiguous sections rotated by the t/h/w
    position ids respectively (Qwen2-VL §2.1).
    """
    half = head_dim // 2
    tot = sum(sections)
    sizes = [half * s // tot for s in sections]
    sizes[0] += half - sum(sizes)
    inv = rope_freqs(head_dim, theta, positions3.device)
    ang = [positions3[i][..., None].to(torch.float32) * inv
           for i in range(3)]
    s0, s1, _ = sizes
    return torch.cat([ang[0][..., :s0], ang[1][..., s0:s0 + s1],
                      ang[2][..., s0 + s1:]], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (B, S, D//2) or (S, D//2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, kind: str = "swiglu",
             dtype: str = "float32", device="cpu") -> dict:
    if kind == "swiglu":
        return {
            "w_gate": init_linear(gen, d, d_ff, dtype=dtype, device=device),
            "w_up": init_linear(gen, d, d_ff, dtype=dtype, device=device),
            "w_down": init_linear(gen, d_ff, d, dtype=dtype, device=device),
        }
    return {
        "w_up": init_linear(gen, d, d_ff, dtype=dtype, device=device),
        "w_down": init_linear(gen, d_ff, d, dtype=dtype, device=device),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as XLA computes it: x · (1 / (1 + exp(−x))), each
    step rounded to x's dtype (XLA expands the logistic so; `F.silu`
    rounds once and is a bfloat16 ulp away for a third of the inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_fwd(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        g = linear_fwd(p["w_gate"], x)
        u = linear_fwd(p["w_up"], x)
        return linear_fwd(p["w_down"], silu(g) * u)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(linear_fwd(p["w_up"], x), approximate="tanh")
    return linear_fwd(p["w_down"], h)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: str = "float32", device="cpu") -> dict:
    return {"w": (normal(gen, (vocab, d), device) * 0.02)
            .to(dtype_of(dtype))}


def embed_fwd(p: dict, tokens: torch.Tensor, compute_dtype: torch.dtype
              ) -> torch.Tensor:
    if ctx.is_dtensor(p["w"]):
        return ctx.embedding(p["w"], tokens).to(compute_dtype)
    return p["w"][tokens.long()].to(compute_dtype)


def unembed_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ ctx.weight(p["w"]).to(x.dtype).T
