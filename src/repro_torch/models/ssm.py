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
each mixer in local regions with its batch on the data axes
(`models.model._mixer`), which is that pin, and a no-op on one device,
and, where the mesh's "model" axis cuts d_inner (Mamba2: the heads)
into whole blocks, tensor parallel over it (`mixer_tp`): each layer is
factored into stages that run on a block of the channels as on the
whole (`_m1_front`/`_m1_back`, `_m2_conv`/`_m2_ssd`/`_m2_back` and
their decode steps), split at the layer's collectives (a block's
partial sums reduced, Mamba2's B and C gathered).

Decode paths keep a conv ring state and the SSM state: O(1) per token.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..sharding import ctx
from .config import ModelConfig
from .layers import dtype_of, init_linear, linear_fwd, normal, silu


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


def _m1_front(p: dict, cfg: ModelConfig, u: torch.Tensor,
              conv_init: torch.Tensor | None = None):
    """Mamba1 up to x_proj: in_proj's x and z columns, the causal conv and
    SiLU on x, and x_proj's (B, L, R + 2N) output.  Returns (x, z, the
    conv input x_raw, dbc).  On a channel block (`mixer_tp`) dbc is that
    block's partial sum."""
    xz = linear_fwd(p["in_proj"], u)
    x_raw, z = torch.chunk(xz, 2, dim=-1)
    x = silu(causal_depthwise_conv(x_raw, p["conv_w"], p["conv_b"],
                                   conv_init))
    return x, z, x_raw, linear_fwd(p["x_proj"], x)


def _m1_dt(p: dict, cfg: ModelConfig, dbc: torch.Tensor):
    """dt (…, di) after dt_proj and the softplus, Bm and Cm (views of the
    x_proj output), A (di, N) float32."""
    r, N = dt_rank(cfg), cfg.ssm.d_state
    dt, Bm, Cm = dbc[..., :r], dbc[..., r:r + N], dbc[..., r + N:]
    dt = softplus(dt @ p["dt_proj"]["w"].to(dt.dtype)
                  + p["dt_proj"]["b"].to(dt.dtype))
    A = -torch.exp(p["A_log"].to(torch.float32))
    return dt, Bm, Cm, A


def _m1_scan_inputs(p: dict, cfg: ModelConfig, u: torch.Tensor,
                    conv_init: torch.Tensor | None = None):
    """The selective scan's inputs of one Mamba1 layer: x (B, L, di) after
    the conv and SiLU, dt (B, L, di) after the softplus, Bm and Cm
    (B, L, N) (views of the x_proj output), A (di, N) float32; and z and
    the conv input x_raw, which the rest of the layer needs."""
    x, z, x_raw, dbc = _m1_front(p, cfg, u, conv_init)
    return (x,) + _m1_dt(p, cfg, dbc), z, x_raw


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


def _m1_back(p: dict, cfg: ModelConfig, x: torch.Tensor, z: torch.Tensor,
             dbc: torch.Tensor, h0: torch.Tensor | None,
             out_dtype: torch.dtype):
    """Mamba1 from x_proj's output on: dt_proj, the chunked scan, D, the
    gate and out_proj.  Returns (out (B, L, d_model), h_last); on a
    channel block out is that block's partial sum."""
    dt, Bm, Cm, A = _m1_dt(p, cfg, dbc)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[-1], cfg.ssm.d_state),
                         dtype=torch.float32, device=x.device)
    y, h_last = _m1_chunked_scan(x, dt, Bm, Cm, A, cfg.ssm.chunk,
                                 dtype_of(cfg.ssm.scan_dtype), h0, out_dtype)
    y = y + x * p["D"].to(x.dtype)
    y = y * silu(z)
    return linear_fwd(p["out_proj"], y), h_last


def _m1_fwd_front(p: dict, cfg: ModelConfig, u: torch.Tensor,
                  conv_init: torch.Tensor | None):
    """`_m1_front` with the next conv state in place of x_raw."""
    x, z, x_raw, dbc = _m1_front(p, cfg, u, conv_init)
    return x, z, _conv_tail(cfg, x_raw, conv_init), dbc


def mamba1_fwd(p: dict, cfg: ModelConfig, u: torch.Tensor,
               init_state: dict | None = None):
    """u (B, L, d_model) -> (y (B, L, d_model), final_state)."""
    st = init_state or {}
    x, z, conv, dbc = _m1_fwd_front(p, cfg, u, st.get("conv"))
    out, h_last = _m1_back(p, cfg, x, z, dbc, st.get("h"), u.dtype)
    return out, {"h": h_last, "conv": conv}


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


def _m1_step_front(p: dict, cfg: ModelConfig, u: torch.Tensor,
                   conv: torch.Tensor):
    """One decode step of `_m1_front`: (xc, z, the next conv state,
    dbc)."""
    xz = linear_fwd(p["in_proj"], u)
    x, z = torch.chunk(xz, 2, dim=-1)                            # (B,1,di)
    xc, conv_in = _conv_step(conv, x, p["conv_w"], p["conv_b"])
    xc = silu(xc)
    return xc, z, conv_in[:, 1:], linear_fwd(p["x_proj"], xc)


def _m1_step_back(p: dict, cfg: ModelConfig, xc: torch.Tensor,
                  z: torch.Tensor, dbc: torch.Tensor, h_prev: torch.Tensor,
                  out_dtype: torch.dtype):
    """One decode step of `_m1_back`: (out, h)."""
    dt, Bm, Cm, A = _m1_dt(p, cfg, dbc)
    dtf = dt[:, 0].to(torch.float32)                             # (B,di)
    a = torch.exp(dtf[..., None] * A)                            # (B,di,N)
    bx = (dtf * xc[:, 0].to(torch.float32))[..., None] \
        * Bm[:, 0].to(torch.float32)[:, None, :]
    h = a * h_prev + bx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].to(torch.float32))[:, None] \
        .to(out_dtype)
    y = y + xc * p["D"].to(xc.dtype)
    y = y * silu(z)
    return linear_fwd(p["out_proj"], y), h


def mamba1_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """u (B, 1, d_model) one token; state {'h': (B,di,N), 'conv':
    (B,K-1,di)}."""
    xc, z, conv, dbc = _m1_step_front(p, cfg, u, state["conv"])
    out, h = _m1_step_back(p, cfg, xc, z, dbc, state["h"], u.dtype)
    return out, {"h": h, "conv": conv}


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


def _m2_block_dims(p: dict, cfg: ModelConfig):
    """(di, P, H, N, G) of the params' heads: every head, or a rank's
    block of them (`mixer_tp`)."""
    P, N = cfg.ssm.head_dim, cfg.ssm.d_state
    H = p["A_log"].shape[-1]
    return H * P, P, H, N, cfg.ssm.n_groups


def _group_heads(bc: torch.Tensor, cfg: ModelConfig, h_off: int, H: int,
                 dim: int) -> torch.Tensor:
    """B or C (…, G, N at ``dim``) broadcast from the groups to heads
    ``h_off`` … ``h_off + H − 1`` of the layer's (head h reads group
    h // (heads / G))."""
    H_all = m2_dims(cfg)[2]
    rep = H_all // bc.shape[dim]
    if h_off == 0 and H == H_all:
        return torch.repeat_interleave(bc, rep, dim=dim)
    idx = torch.arange(h_off, h_off + H, device=bc.device) // rep
    return bc.index_select(dim, idx)


def _gate(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor):
    """The gated norm's input g = y · silu(z) (float32: XLA drops the
    round trip through y's dtype between the product and the norm, and
    the reference's bfloat16 output moves by a bfloat16 ulp on a quarter
    of the elements otherwise) and its mean of squares over d_inner.  On
    a block of the channels the mean is that block's share of it, a
    partial sum over the blocks."""
    g = y.to(torch.float32) * silu(z).to(torch.float32)
    ms = torch.mean(g * g, dim=-1, keepdim=True)
    if g.shape[-1] != cfg.d_inner:
        ms = ms * (g.shape[-1] / cfg.d_inner)
    return g, ms


def _m2_back(p: dict, cfg: ModelConfig, g: torch.Tensor, ms: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """The gated RMSNorm of g given its mean of squares, in
    ``out_dtype``, then out_proj; on a block of heads a partial sum."""
    y = g * torch.rsqrt(ms + cfg.norm_eps)
    y = (y * p["norm_scale"].to(torch.float32)).to(out_dtype)
    return linear_fwd(p["out_proj"], y)


def _m2_conv(p: dict, cfg: ModelConfig, u: torch.Tensor, di: int,
             conv_init: torch.Tensor | None = None):
    """Mamba2 up to the conv: in_proj's [z | xBC | dt] columns (z ``di``
    wide, xBC as wide as the conv), the causal conv and SiLU over xBC,
    dt's softplus.  Returns (z, xbc, dt, the conv input xbc_raw)."""
    zxbcdt = linear_fwd(p["in_proj"], u)
    n = p["conv_w"].shape[-1]
    z, xbc_raw, dt = (zxbcdt[..., :di], zxbcdt[..., di:di + n],
                      zxbcdt[..., di + n:])
    xbc = silu(causal_depthwise_conv(xbc_raw, p["conv_w"], p["conv_b"],
                                     conv_init))
    dt = softplus(dt + p["dt_bias"].to(dt.dtype))                 # (B,L,H)
    return z, xbc, dt, xbc_raw


def _m2_fwd_conv(p: dict, cfg: ModelConfig, u: torch.Tensor, di: int,
                 conv_init: torch.Tensor | None):
    """`_m2_conv` with the next conv state in place of xbc_raw."""
    z, xbc, dt, xbc_raw = _m2_conv(p, cfg, u, di, conv_init)
    return z, xbc, dt, _conv_tail(cfg, xbc_raw, conv_init)


def _m2_heads(p: dict, cfg: ModelConfig, x: torch.Tensor, bc: torch.Tensor):
    """x (…, di) as (…, H, P); B and C of every group (…, G, N) (views of
    ``bc``, the conv output's (…, 2GN) B and C columns); A (H,)
    float32."""
    di, P, H, N, G = _m2_block_dims(p, cfg)
    lead = x.shape[:-1]
    return (x.reshape(lead + (H, P)), bc[..., :G * N].reshape(lead + (G, N)),
            bc[..., G * N:].reshape(lead + (G, N)),
            -torch.exp(p["A_log"].to(torch.float32)))


def _m2_scan_inputs(p: dict, cfg: ModelConfig, u: torch.Tensor,
                    conv_init: torch.Tensor | None = None):
    """The SSD scan's inputs of one Mamba2 layer: x (B, L, H, P), Bm and Cm
    (B, L, G, N) (strided views of the conv output), dt (B, L, H) after
    the softplus, A (H,) float32; and z and the conv input xbc_raw."""
    di = _m2_block_dims(p, cfg)[0]
    z, xbc, dt, xbc_raw = _m2_conv(p, cfg, u, di, conv_init)
    x, Bm, Cm, A = _m2_heads(p, cfg, xbc[..., :di], xbc[..., di:])
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


def _m2_ssd(p: dict, cfg: ModelConfig, z: torch.Tensor, x: torch.Tensor,
            bc: torch.Tensor, dt: torch.Tensor, h0: torch.Tensor | None,
            out_dtype: torch.dtype, h_off: int = 0):
    """Mamba2 from the conv's output to the gated norm: the SSD chunked
    scan over the params' heads (the first is head ``h_off``) of x
    (B, L, di) and dt (B, L, H), with all of B and C (B, L, 2GN), then D
    and the gate.  Returns (g, its mean of squares, h_last)."""
    Bsz, L = x.shape[:2]
    di, P, H, N, _ = _m2_block_dims(p, cfg)
    x, Bm, Cm, A = _m2_heads(p, cfg, x, bc)
    Bh = _group_heads(Bm, cfg, h_off, H, 2)                       # (B,L,H,N)
    Ch = _group_heads(Cm, cfg, h_off, H, 2)
    if h0 is None:
        h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device)
    y, h_last = _m2_chunked_scan(x, dt, Bh, Ch, A, cfg.ssm.chunk, h0,
                                 out_dtype)
    y = y + x * p["D"].to(x.dtype)[None, None, :, None]
    g, ms = _gate(cfg, y.reshape(Bsz, L, di), z)
    return g, ms, h_last


def mamba2_fwd(p: dict, cfg: ModelConfig, u: torch.Tensor,
               init_state: dict | None = None):
    """u (B, L, d_model) -> (y, final_state). SSD chunked algorithm."""
    st = init_state or {}
    di = cfg.d_inner
    z, xbc, dt, conv = _m2_fwd_conv(p, cfg, u, di, st.get("conv"))
    g, ms, h_last = _m2_ssd(p, cfg, z, xbc[..., :di], xbc[..., di:], dt,
                            st.get("h"), u.dtype)
    return _m2_back(p, cfg, g, ms, u.dtype), {"h": h_last, "conv": conv}


def _m2_step_conv(p: dict, cfg: ModelConfig, u: torch.Tensor, di: int,
                  conv: torch.Tensor):
    """One decode step of `_m2_fwd_conv`: (z, xbc, dt, the next conv
    state)."""
    zxbcdt = linear_fwd(p["in_proj"], u)
    n = p["conv_w"].shape[-1]
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:di + n], zxbcdt[..., di + n:]
    xbc, conv_in = _conv_step(conv, xbc, p["conv_w"], p["conv_b"])
    dt = softplus(dt + p["dt_bias"].to(dt.dtype))
    return z, silu(xbc), dt, conv_in[:, 1:]


def _m2_step_ssd(p: dict, cfg: ModelConfig, z: torch.Tensor,
                 x: torch.Tensor, bc: torch.Tensor, dt: torch.Tensor,
                 h_prev: torch.Tensor, out_dtype: torch.dtype,
                 h_off: int = 0):
    """One decode step of `_m2_ssd`: (g, its mean of squares, h)."""
    Bsz = x.shape[0]
    di, _, H, _, _ = _m2_block_dims(p, cfg)
    x, Bm, Cm, A = _m2_heads(p, cfg, x[:, 0], bc[:, 0])
    Bh = _group_heads(Bm, cfg, h_off, H, 1).to(torch.float32)      # (B,H,N)
    Ch = _group_heads(Cm, cfg, h_off, H, 1).to(torch.float32)
    dt = dt[:, 0].to(torch.float32)
    a = torch.exp(dt * A)                                         # (B,H)
    dx = dt[..., None] * x.to(torch.float32)                      # (B,H,P)
    h = a[..., None, None] * h_prev + torch.einsum("bhn,bhp->bhpn",
                                                   Bh, dx)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y + x.to(torch.float32) * p["D"].to(torch.float32)[None, :, None]
    g, ms = _gate(cfg, y.reshape(Bsz, 1, di).to(out_dtype), z)
    return g, ms, h


def mamba2_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """One-token decode. u (B,1,d); state {'h': (B,H,P,N), 'conv':
    (B,K-1,conv_dim)}."""
    di = cfg.d_inner
    z, xbc, dt, conv = _m2_step_conv(p, cfg, u, di, state["conv"])
    g, ms, h = _m2_step_ssd(p, cfg, z, xbc[..., :di], xbc[..., di:], dt,
                            state["h"], u.dtype)
    return _m2_back(p, cfg, g, ms, u.dtype), {"h": h, "conv": conv}


def init_mamba2_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    di, P, H, N = m2_dims(cfg)
    conv_dim = di + 2 * cfg.ssm.n_groups * N
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, conv_dim),
                                dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# Tensor parallel over d_inner (Mamba2: heads) on a mesh's "model" axis
# ---------------------------------------------------------------------------

CH = {0: "dp", 2: "model"}      # (B, L, channels): batch on dp, channels
H_CH = {0: "dp", 1: "model"}    # the SSM state (B, di, N) / (B, H, P, N)
PART = {0: "dp", ctx.PARTIAL: "model"}      # a channel block's partial sum
BATCH = {0: "dp"}
# Each leaf's layout in its stage's region: in_proj is gathered and the
# rank's columns taken inside the region (its at-rest column blocks cut
# across x and z, or z, xBC and dt), and so are Mamba2's conv weights;
# the rest are split on their channel dim, where the rules split them
# already (or locally, where the rules replicate them).
_M1_FRONT = {"in_proj": None, "conv_w": {1: "model"}, "conv_b": {0: "model"},
             "x_proj": {"w": {0: "model"}}}
_M1_BACK = {"dt_proj": {"w": {1: "model"}, "b": {0: "model"}},
            "A_log": {0: "model"}, "D": {0: "model"},
            "out_proj": {"w": {0: "model"}}}
_M2_CONV = {"in_proj": None, "conv_w": None, "conv_b": None,
            "dt_bias": {0: "model"}}
_M2_SSD = {"A_log": {0: "model"}, "D": {0: "model"}}
_M2_BACK = {"norm_scale": {0: "model"}, "out_proj": {"w": {0: "model"}}}


def tp_blocks(cfg: ModelConfig, m: int) -> bool:
    """Does a "model" axis of ``m`` ranks cut the mixer into whole channel
    blocks: d_inner (Mamba1), or the heads and B and C's 2GN channels
    (Mamba2)?"""
    if cfg.ssm.kind == "mamba1":
        return cfg.d_inner % m == 0
    return m2_dims(cfg)[2] % m == 0 \
        and 2 * cfg.ssm.n_groups * cfg.ssm.d_state % m == 0


def _model_rank(x) -> Tuple[int, int]:
    """(this rank's coordinate, size) of the "model" axis of ``x``'s
    mesh."""
    mesh = x.device_mesh
    i = tuple(mesh.mesh_dim_names).index("model")
    return mesh.get_coordinate()[i], mesh.size(i)


def _take(lin: dict, idx: torch.Tensor) -> dict:
    """A linear's output columns ``idx`` (weight and bias)."""
    return {k: v.index_select(-1, idx) for k, v in lin.items()}


def _span(a: int, b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(a, b, device=like.device)


def _sub(p: dict, layout: dict) -> dict:
    return {k: p[k] for k in layout}


def mixer_tp(p: dict, cfg: ModelConfig, u, state: dict | None,
             decode: bool = False):
    """A Mamba mixer (`mamba1_fwd`/`_decode`, `mamba2_fwd`/`_decode`) on
    a device mesh, tensor parallel over the "model" axis: each rank runs
    its block of d_inner (Mamba2: of the heads) in local regions split
    at the collectives inside the layer (Mamba1: x_proj's row-parallel
    product, reduced before dt, B and C are split off it; Mamba2: B and
    C gathered after the conv, the gated norm's mean of squares over
    d_inner reduced before the rsqrt).  ``u`` (B, L, d_model) is batch
    on the data axes and replicated on "model"; the output is out_proj's
    row-parallel partial sum on "model" (the caller reduces it), and the
    states come back with their d_inner or heads on "model", except
    Mamba2's conv state, a partial sum of its full width (see `_m2_tp`).
    Requires `tp_blocks`; counts its calls in ``mixer_tp.calls``."""
    mixer_tp.calls += 1
    tp = _m1_tp if cfg.ssm.kind == "mamba1" else _m2_tp
    return tp(p, cfg, u, state or {}, decode)


mixer_tp.calls = 0


def _m1_tp(p: dict, cfg: ModelConfig, u, st: dict, decode: bool):
    di = cfg.d_inner
    r, m = _model_rank(u)
    c = di // m
    front, back = ((_m1_step_front, _m1_step_back) if decode
                   else (_m1_fwd_front, _m1_back))

    def first(p1, u, conv):
        cols = torch.cat([_span(r * c, (r + 1) * c, u),
                          _span(di + r * c, di + (r + 1) * c, u)])
        return front(dict(p1, in_proj=_take(p1["in_proj"], cols)), cfg, u,
                     conv)

    x, z, conv, dbc = ctx.local(first, (_sub(p, _M1_FRONT), u,
                                        st.get("conv")),
                                [_M1_FRONT, BATCH, CH], (CH, CH, CH, PART))
    dbc = ctx.to_layout(dbc, BATCH)             # x_proj's partial sums
    out, h = ctx.local(
        lambda p2, x, z, dbc, h: back(p2, cfg, x, z, dbc, h, u.dtype),
        (_sub(p, _M1_BACK), x, z, dbc, st.get("h")),
        [_M1_BACK, CH, CH, BATCH, H_CH], (PART, H_CH))
    return out, {"h": h, "conv": conv}


def _m2_tp(p: dict, cfg: ModelConfig, u, st: dict, decode: bool):
    """Mamba2's heads split: each rank reads z, x and dt of its heads and
    a 1/m slice of B and C's channels from in_proj, runs the conv over
    them, and gathers B and C whole (the heads of a group share them;
    projected on every rank, zamba2's 128 B and C columns would take a
    rank's share of in_proj from 524 columns to 644).  The conv state is
    (B, K − 1, di + 2GN), which `cache_pspecs` cuts into even blocks of
    that width: they do not line up with a rank's channels (zamba2:
    4,224 / 16 = 264 against 256 x channels and 8 of B and C a rank).
    The state is small, so the region reads it whole and takes its
    channels, and hands the next state back at full width as a partial
    sum on "model" (each rank's channels, zeros elsewhere), which the
    caller reduces into the placement the state came in."""
    di, P, H, N = m2_dims(cfg)
    gn2 = 2 * cfg.ssm.n_groups * N
    r, m = _model_rank(u)
    nh, s = H // m, gn2 // m
    c = nh * P
    conv_fn, ssd = ((_m2_step_conv, _m2_step_ssd) if decode
                    else (_m2_fwd_conv, _m2_ssd))

    def first(p1, u, conv):
        ch = torch.cat([_span(r * c, (r + 1) * c, u),
                        _span(di + r * s, di + (r + 1) * s, u)])
        cols = torch.cat([_span(r * c, (r + 1) * c, u), di + ch,
                          _span(2 * di + gn2 + r * nh,
                                2 * di + gn2 + (r + 1) * nh, u)])
        pb = dict(p1, in_proj=_take(p1["in_proj"], cols),
                  conv_w=p1["conv_w"].index_select(-1, ch),
                  conv_b=p1["conv_b"].index_select(-1, ch))
        z, xbc, dt, tail = conv_fn(
            pb, cfg, u, c, None if conv is None else conv.index_select(-1, ch))
        full = tail.new_zeros(tail.shape[:-1] + (di + gn2,))
        full.index_copy_(full.dim() - 1, ch, tail)
        return z, xbc[..., :c], xbc[..., c:], dt, full

    z, x, bc, dt, conv = ctx.local(
        first, (_sub(p, _M2_CONV), u, st.get("conv")),
        [_M2_CONV, BATCH, BATCH], (CH, CH, CH, CH, PART))
    bc = ctx.to_layout(bc, BATCH)               # all of B and C
    g, ms, h = ctx.local(
        lambda p2, z, x, bc, dt, h: ssd(p2, cfg, z, x, bc, dt, h, u.dtype,
                                        r * nh),
        (_sub(p, _M2_SSD), z, x, bc, dt, st.get("h")),
        [_M2_SSD, CH, CH, BATCH, CH, H_CH], (CH, PART, H_CH))
    ms = ctx.to_layout(ms, BATCH)       # the mean of squares over d_inner
    out = ctx.local(lambda p2, g, ms: _m2_back(p2, cfg, g, ms, u.dtype),
                    (_sub(p, _M2_BACK), g, ms), [_M2_BACK, CH, BATCH], PART)
    return out, {"h": h, "conv": conv}
