"""State-space sequence mixers: Mamba1 (selective scan) and Mamba2 (SSD).

Port of `repro.models.ssm`, function for function, on nested dicts of
tensors with the reference's keys and layouts.  Both forwards use the
reference's *chunked* scan: the sequence is split into chunks of
``cfg.ssm.chunk``, a loop carries the SSM state (float32) from chunk to
chunk, and inside a chunk Mamba1 runs an associative scan and Mamba2 the
SSD matmul form.  The kernels K8 (`kernels.selective_scan`) and K7
(`kernels.ssd_scan`) compute these inner scans; as in the reference, the
model does not call them.

`associative_scan` is the recursion of `jax.lax.associative_scan`, so the
bfloat16 scan elements of falcon-mamba (``scan_dtype="bfloat16"``) are
rounded in the reference's order.  The reference pins the scans'
operands' batch dim (`constrain_batch`); on a device mesh the port runs
each mixer in a local region with its batch on the data axes
(`models.model._mixer`), which is that pin, and a no-op on one device.

Decode paths keep a conv ring state and the SSM state: O(1) per token.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (dtype_of, init_linear, linear_fwd, normal, norm_fwd,
                     silu)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, i.e. logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)) (torch's own softplus switches to x above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          init_state: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """x (B, L, D); w (K, D); b (D). Causal depthwise conv along L."""
    K = w.shape[0]
    L = x.shape[1]
    if init_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + L] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _chunk(x: torch.Tensor, c: int) -> Tuple[torch.Tensor, int]:
    """(B, L, ...) -> (n, B, c, ...) with zero padding; returns
    (chunked, L)."""
    B, L = x.shape[:2]
    n = -(-L // c)
    pad = n * c - L
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    x = x.reshape((B, n, c) + tuple(x.shape[2:]))
    return x.movedim(1, 0), L


def _unchunk(y: torch.Tensor, L: int) -> torch.Tensor:
    """(n, B, c, ...) -> (B, L, ...)."""
    y = y.movedim(0, 1)
    B, n, c = y.shape[:3]
    return y.reshape((B, n * c) + tuple(y.shape[3:]))[:, :L]


def associative_scan(fn: Callable, elems: Tuple[torch.Tensor, ...],
                     axis: int = 0) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the associative ``fn`` over ``axis``, by the
    recursion of `jax.lax.associative_scan`: combine adjacent pairs,
    scan the result, combine it with the elements at 2::2, prepend the
    first element and interleave.  log2(n) levels of whole-tensor ops.
    The prepend and the interleave (exact copies in the reference) write
    straight into each level's output."""
    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return tuple(idx)

    def scan(el):
        n = el[0].shape[axis]
        if n < 2:
            return el
        reduced = fn(tuple(e[sl(e, 0, n - 1, 2)] for e in el),
                     tuple(e[sl(e, 1, None, 2)] for e in el))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(o[sl(o, 0, -1)] for o in odd),
                      tuple(e[sl(e, 2, None, 2)] for e in el))
        else:
            even = fn(odd, tuple(e[sl(e, 2, None, 2)] for e in el))
        out = []
        for e, ev, o in zip(el, even, odd):
            r = torch.empty_like(e)
            r[sl(r, 0, 1)] = e[sl(e, 0, 1)]
            r[sl(r, 2, None, 2)] = ev
            r[sl(r, 1, None, 2)] = o
            out.append(r)
        return tuple(out)

    return scan(tuple(elems))


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba-7b): per-(channel,state) selective scan
# ---------------------------------------------------------------------------

def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba1(gen: torch.Generator, cfg: ModelConfig,
                dtype: str = "float32", device="cpu") -> dict:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm.d_state
    K = cfg.ssm.d_conv
    r = dt_rank(cfg)
    dt = dtype_of(dtype)
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None].repeat(di, 1)
    u = torch.rand(di, generator=gen, device=gen.device).to(device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    return {
        "in_proj": init_linear(gen, d, 2 * di, dtype=dtype, device=device),
        "conv_w": (normal(gen, (K, di), device) / math.sqrt(K)).to(dt),
        "conv_b": torch.zeros(di, dtype=dt, device=device),
        "x_proj": init_linear(gen, di, r + 2 * N, dtype=dtype,
                              device=device),
        "dt_proj": {"w": (normal(gen, (r, di), device) * r ** -0.5).to(dt),
                    "b": (lo + (hi - lo) * u).to(dt)},
        "A_log": torch.log(A).to(dt),
        "D": torch.ones(di, dtype=dt, device=device),
        "out_proj": init_linear(gen, di, d, dtype=dtype, device=device),
    }


def _m1_scan_chunk(h0: torch.Tensor, la: torch.Tensor, bx: torch.Tensor):
    """Within-chunk recurrence via associative scan.

    la (B, c, D, N) log decay; bx (B, c, D, N) input term.
    h_t = exp(la_t) * h_{t-1} + bx_t. Returns (h_all (B,c,D,N), h_last).
    """
    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 + a2, b2 + torch.exp(a2) * b1

    a_cum, b_cum = associative_scan(combine, (la, bx), axis=1)
    h_all = b_cum + torch.exp(a_cum) * h0[:, None]
    return h_all, h_all[:, -1]


def _m1_scan_inputs(p: dict, cfg: ModelConfig, u: torch.Tensor,
                    conv_init: torch.Tensor | None = None):
    """The selective scan's inputs of one Mamba1 layer: x (B, L, di) after
    the conv and SiLU, dt (B, L, di) after the softplus, Bm and Cm
    (B, L, N) (views of the x_proj output), A (di, N) float32; and z and
    the conv input x_raw, which the rest of the layer needs."""
    r, N = dt_rank(cfg), cfg.ssm.d_state
    xz = linear_fwd(p["in_proj"], u)
    x_raw, z = torch.chunk(xz, 2, dim=-1)
    x = silu(causal_depthwise_conv(x_raw, p["conv_w"], p["conv_b"],
                                   conv_init))
    dbc = linear_fwd(p["x_proj"], x)
    dt, Bm, Cm = dbc[..., :r], dbc[..., r:r + N], dbc[..., r + N:]
    dt = softplus(dt @ p["dt_proj"]["w"].to(dt.dtype)
                  + p["dt_proj"]["b"].to(dt.dtype))                 # (B,L,di)
    A = -torch.exp(p["A_log"].to(torch.float32))                     # (di,N)
    return (x, dt, Bm, Cm, A), z, x_raw


def _m1_chunked_scan(x, dt, Bm, Cm, A, chunk: int, scan_dtype: torch.dtype,
                     h0: torch.Tensor, out_dtype: torch.dtype):
    """The reference's chunked Mamba1 scan: h_t = exp(dt_t·A)∘h_{t−1} +
    (dt_t·x_t)⊗B_t, y_t = h_t·C_t, with the decay and input terms and the
    within-chunk scan in ``scan_dtype`` and the state carried between
    chunks in float32.  Returns (y (B, L, D) in ``out_dtype``, h_last
    (B, D, N) float32)."""
    L = x.shape[1]
    xs, _ = _chunk(x, chunk)
    dts, _ = _chunk(dt, chunk)
    Bs, _ = _chunk(Bm, chunk)
    Cs, _ = _chunk(Cm, chunk)
    h = h0
    ys = []
    for xc, dtc, Bc, Cc in zip(xs, dts, Bs, Cs):
        dtf = dtc.to(torch.float32)
        la = (dtf[..., None] * A).to(scan_dtype)                  # (B,c,di,N)
        bx = ((dtf * xc.to(torch.float32))[..., None]
              * Bc.to(torch.float32)[:, :, None, :]).to(scan_dtype)
        h_all, h_last = _m1_scan_chunk(h.to(scan_dtype), la, bx)
        yc = torch.einsum("bcdn,bcn->bcd", h_all, Cc.to(scan_dtype))
        h = h_last.to(torch.float32)
        ys.append(yc.to(out_dtype))
    return _unchunk(torch.stack(ys), L), h


def mamba1_fwd(p: dict, cfg: ModelConfig, u: torch.Tensor,
               init_state: dict | None = None):
    """u (B, L, d_model) -> (y (B, L, d_model), final_state)."""
    B = u.shape[0]
    di, N = cfg.d_inner, cfg.ssm.d_state
    conv_init = init_state["conv"] if init_state is not None else None
    (x, dt, Bm, Cm, A), z, x_raw = _m1_scan_inputs(p, cfg, u, conv_init)
    h0 = (init_state["h"] if init_state is not None
          else torch.zeros((B, di, N), dtype=torch.float32, device=u.device))
    y, h_last = _m1_chunked_scan(x, dt, Bm, Cm, A, cfg.ssm.chunk,
                                 dtype_of(cfg.ssm.scan_dtype), h0, u.dtype)
    y = y + x * p["D"].to(x.dtype)
    y = y * silu(z)
    out = linear_fwd(p["out_proj"], y)
    return out, {"h": h_last, "conv": _conv_tail(cfg, x_raw, conv_init)}


def _conv_tail(cfg: ModelConfig, x_raw: torch.Tensor,
               conv_init: torch.Tensor | None) -> torch.Tensor:
    """The last d_conv − 1 conv inputs (the decode conv state), in the
    conv input's dtype."""
    if conv_init is not None:
        hist = torch.cat([conv_init.to(x_raw.dtype), x_raw], dim=1)
    else:
        hist = F.pad(x_raw, (0, 0, cfg.ssm.d_conv - 1, 0))
    return hist[:, -(cfg.ssm.d_conv - 1):]


def _conv_step(state_conv: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One decode step of the depthwise conv: (output (B, 1, D), the
    window (B, K, D) whose last K − 1 rows are the next state)."""
    conv_in = torch.cat([state_conv.to(x.dtype), x], dim=1)
    xc = torch.einsum("bkd,kd->bd", conv_in, w.to(x.dtype))[:, None] \
        + b.to(x.dtype)
    return xc, conv_in


def mamba1_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """u (B, 1, d_model) one token; state {'h': (B,di,N), 'conv':
    (B,K-1,di)}."""
    r, N = dt_rank(cfg), cfg.ssm.d_state
    xz = linear_fwd(p["in_proj"], u)
    x, z = torch.chunk(xz, 2, dim=-1)                            # (B,1,di)
    xc, conv_in = _conv_step(state["conv"], x, p["conv_w"], p["conv_b"])
    xc = silu(xc)
    dbc = linear_fwd(p["x_proj"], xc)
    dt, Bm, Cm = dbc[..., :r], dbc[..., r:r + N], dbc[..., r + N:]
    dt = softplus(dt @ p["dt_proj"]["w"].to(dt.dtype)
                  + p["dt_proj"]["b"].to(dt.dtype))
    A = -torch.exp(p["A_log"].to(torch.float32))
    dtf = dt[:, 0].to(torch.float32)                             # (B,di)
    a = torch.exp(dtf[..., None] * A)                            # (B,di,N)
    bx = (dtf * xc[:, 0].to(torch.float32))[..., None] \
        * Bm[:, 0].to(torch.float32)[:, None, :]
    h = a * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].to(torch.float32))[:, None] \
        .to(u.dtype)
    y = y + xc * p["D"].to(xc.dtype)
    y = y * silu(z)
    out = linear_fwd(p["out_proj"], y)
    return out, {"h": h, "conv": conv_in[:, 1:]}


def init_mamba1_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.ssm.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, cfg.d_inner),
                                dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# Mamba2 (zamba2): scalar-per-head decay, SSD chunked matmul form
# ---------------------------------------------------------------------------

def m2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    di = cfg.d_inner
    P = cfg.ssm.head_dim
    H = di // P
    return di, P, H, cfg.ssm.d_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig,
                dtype: str = "float32", device="cpu") -> dict:
    d = cfg.d_model
    di, P, H, N = m2_dims(cfg)
    G = cfg.ssm.n_groups
    K = cfg.ssm.d_conv
    conv_dim = di + 2 * G * N
    dt = dtype_of(dtype)
    u = torch.rand(H, generator=gen, device=gen.device).to(device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    return {
        "in_proj": init_linear(gen, d, 2 * di + 2 * G * N + H, dtype=dtype,
                               device=device),
        "conv_w": (normal(gen, (K, conv_dim), device)
                   / math.sqrt(K)).to(dt),
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "A_log": torch.zeros(H, dtype=dt, device=device),
        "D": torch.ones(H, dtype=dt, device=device),
        "dt_bias": (lo + (hi - lo) * u).to(dt),
        "norm_scale": torch.ones(di, dtype=dt, device=device),
        "out_proj": init_linear(gen, di, d, dtype=dtype, device=device),
    }


def _gated_norm(p: dict, cfg: ModelConfig, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y · silu(z)) in y's dtype.  The product goes into the
    norm's float32 unrounded: XLA drops the round trip through y's dtype
    between the two (the reference's bfloat16 output moves by a bfloat16
    ulp on a quarter of the elements otherwise)."""
    g = y.to(torch.float32) * silu(z).to(torch.float32)
    return norm_fwd("rmsnorm", {"scale": p["norm_scale"]}, g,
                    cfg.norm_eps).to(y.dtype)


def _m2_split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, P, H, N = m2_dims(cfg)
    G = cfg.ssm.n_groups
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    return z, xbc, dt


def _m2_scan_inputs(p: dict, cfg: ModelConfig, u: torch.Tensor,
                    conv_init: torch.Tensor | None = None):
    """The SSD scan's inputs of one Mamba2 layer: x (B, L, H, P), Bm and Cm
    (B, L, G, N) (strided views of the conv output), dt (B, L, H) after
    the softplus, A (H,) float32; and z and the conv input xbc_raw."""
    Bsz, L, _ = u.shape
    di, P, H, N = m2_dims(cfg)
    G = cfg.ssm.n_groups
    zxbcdt = linear_fwd(p["in_proj"], u)
    z, xbc_raw, dt = _m2_split(cfg, zxbcdt)
    xbc = silu(causal_depthwise_conv(xbc_raw, p["conv_w"], p["conv_b"],
                                     conv_init))
    x = xbc[..., :di].reshape(Bsz, L, H, P)
    Bm = xbc[..., di:di + G * N].reshape(Bsz, L, G, N)
    Cm = xbc[..., di + G * N:].reshape(Bsz, L, G, N)
    dt = softplus(dt + p["dt_bias"].to(dt.dtype))                 # (B,L,H)
    A = -torch.exp(p["A_log"].to(torch.float32))                  # (H,)
    return (x, dt, Bm, Cm, A), z, xbc_raw


def _m2_chunked_scan(x, dt, Bh, Ch, A, chunk: int, h0: torch.Tensor,
                     out_dtype: torch.dtype):
    """The reference's chunked SSD: per chunk a diagonal term through the
    masked decay kernel, the carried state's term, and the state update,
    all in float32.  x (B, L, H, P), dt (B, L, H), Bh, Ch (B, L, H, N) (the
    groups broadcast to heads), A (H,).  Returns (y (B, L, H, P) in
    ``out_dtype``, h_last (B, H, P, N) float32)."""
    L = x.shape[1]
    c = chunk
    xs, _ = _chunk(x, c)
    dts, _ = _chunk(dt, c)
    Bs, _ = _chunk(Bh, c)
    Cs, _ = _chunk(Ch, c)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = h0
    ys = []
    for xc, dtc, Bc, Cc in zip(xs, dts, Bs, Cs):
        dtf = dtc.to(torch.float32)
        la = dtf * A                                          # (B,c,H)
        Lcum = torch.cumsum(la, dim=1)                        # (B,c,H)
        decay = torch.exp(Lcum[:, :, None] - Lcum[:, None, :])  # (B,c,c,H)
        Cf, Bf = Cc.to(torch.float32), Bc.to(torch.float32)
        scores = torch.einsum("bthn,bshn->btsh", Cf, Bf)
        M = torch.where(tri[None, :, :, None], decay * scores, zero)
        dx = dtf[..., None] * xc.to(torch.float32)            # (B,c,H,P)
        y_diag = torch.einsum("btsh,bshp->bthp", M, dx)
        y_prev = torch.einsum("bthn,bhpn->bthp",
                              Cf * torch.exp(Lcum)[..., None], h)
        tail = torch.exp(Lcum[:, -1:, :] - Lcum)              # (B,c,H)
        h = torch.exp(Lcum[:, -1])[..., None, None] * h + torch.einsum(
            "bshn,bshp->bhpn", Bf * tail[..., None], dx)
        ys.append((y_diag + y_prev).to(out_dtype))
    return _unchunk(torch.stack(ys), L), h


def mamba2_fwd(p: dict, cfg: ModelConfig, u: torch.Tensor,
               init_state: dict | None = None):
    """u (B, L, d_model) -> (y, final_state). SSD chunked algorithm."""
    Bsz, L, _ = u.shape
    di, P, H, N = m2_dims(cfg)
    conv_init = init_state["conv"] if init_state is not None else None
    (x, dt, Bm, Cm, A), z, xbc_raw = _m2_scan_inputs(p, cfg, u, conv_init)
    rep = H // cfg.ssm.n_groups                   # broadcast groups to heads
    Bh = torch.repeat_interleave(Bm, rep, dim=2)                  # (B,L,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    h0 = (init_state["h"] if init_state is not None
          else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                           device=u.device))
    y, h_last = _m2_chunked_scan(x, dt, Bh, Ch, A, cfg.ssm.chunk, h0,
                                 u.dtype)
    y = y + x * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, L, di)
    y = _gated_norm(p, cfg, y, z)
    out = linear_fwd(p["out_proj"], y)
    # conv state tail (pre-activation xbc)
    return out, {"h": h_last, "conv": _conv_tail(cfg, xbc_raw, conv_init)}


def mamba2_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """One-token decode. u (B,1,d); state {'h': (B,H,P,N), 'conv':
    (B,K-1,conv_dim)}."""
    Bsz = u.shape[0]
    di, P, H, N = m2_dims(cfg)
    G = cfg.ssm.n_groups
    zxbcdt = linear_fwd(p["in_proj"], u)
    z, xbc, dt = _m2_split(cfg, zxbcdt)
    xbc, conv_in = _conv_step(state["conv"], xbc, p["conv_w"], p["conv_b"])
    xbc = silu(xbc)
    x = xbc[..., :di].reshape(Bsz, H, P)
    Bm = xbc[..., di:di + G * N].reshape(Bsz, G, N)
    Cm = xbc[..., di + G * N:].reshape(Bsz, G, N)
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1).to(torch.float32)  # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).to(torch.float32)
    dt = softplus(dt[:, 0] + p["dt_bias"].to(dt.dtype)).to(torch.float32)
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = torch.exp(dt * A)                                         # (B,H)
    dx = dt[..., None] * x.to(torch.float32)                      # (B,H,P)
    h = a[..., None, None] * state["h"] + torch.einsum("bhn,bhp->bhpn",
                                                       Bh, dx)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y + x.to(torch.float32) * p["D"].to(torch.float32)[None, :, None]
    y = y.reshape(Bsz, 1, di).to(u.dtype)
    y = _gated_norm(p, cfg, y, z)
    out = linear_fwd(p["out_proj"], y)
    return out, {"h": h, "conv": conv_in[:, 1:]}


def init_mamba2_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    di, P, H, N = m2_dims(cfg)
    conv_dim = di + 2 * cfg.ssm.n_groups * N
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, conv_dim),
                                dtype=torch.float32, device=device)}
