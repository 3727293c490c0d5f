"""The arithmetic of K6's bf16 route on the tensor cores, checked on the CPU.

`csrc/flash_attention.cu` runs bf16 attention as `mma.sync` products of
bf16 operands with float32 sums.  It keeps the TPU kernel's float32 numbers
by splitting each float32 operand into bf16 terms:

  * q * float32(1/sqrt(D)) into hi + mid + lo, whose float32 sum is the
    product exactly (one term where the scale is a power of two, D = 64);
  * p = exp(s - m) into hi + lo, with |p - hi - lo| <= 2^-16 p.

bf16 x bf16 products are exact in float32, so the kernel forms the
reference's products for the scores, and for PV up to the 2^-16 p
residual.  This file checks the two splits, then runs an emulation of the
route (written here, not in the package: the split operands, exact
products, float32 sums over the kernel's 64 x 64 tiles in its order)
against the unchanged `flash_attention_plain`, at the limits that
chip_smoke.py holds the kernel to on the card (`flash_held`): 1e-5 plus
one bf16 ulp of the larger value.  The emulation adds in IEEE float32;
the tensor cores align and truncate the products inside each MMA, so it
checks the operand splits and the tile order, not the card's rounding of
the sums.  That is bounded by the checks on the card (chip_smoke.py phase
3 and its per-layer check, tests/test_torch_cuda.py).  Inputs come from
fixed numpy seeds.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

ATTN_F32_TOL = 1e-5     # chip_smoke.flash_held, restated
TILE = 64               # the kernel's q and kv tile


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest-even bf16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x: torch.Tensor, n: int):
    """float32 ``x`` as ``n`` bf16 terms: each the bf16 rounding of what
    the earlier terms leave."""
    terms = []
    for _ in range(n):
        terms.append(_bf16(x))
        x = x - terms[-1]
    return terms


def _q_terms(d: int) -> int:
    """The kernel's number of q terms: 1 where the scale is a power of
    two, else 3."""
    return 1 if math.frexp(float(np.float32(1.0 / math.sqrt(d))))[0] == 0.5 \
        else 3


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _scaled_q(d: int, seed: int) -> torch.Tensor:
    q = torch.tensor(np.random.default_rng(seed).normal(size=(4096,))
                     .astype(np.float32)).to(torch.bfloat16)
    return q.to(torch.float32) * torch.tensor(np.float32(1.0 / math.sqrt(d)))


def _values(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(11)
    if kind == "normals":
        x = rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, size=4096)
        return torch.tensor(x.astype(np.float32))
    # 2^k and its float32 neighbours within 40 ulps on both sides
    base = (2.0 ** np.arange(-30, 31)).astype(np.float32)
    x = (base.view(np.int32)[:, None] + np.arange(-40, 41)[None, :]) \
        .astype(np.int32).view(np.float32).ravel()
    return torch.tensor(np.concatenate([x, -x]))


@pytest.mark.parametrize("kind", ["normals", "near powers of two",
                                  "q scaled, D=64", "q scaled, D=80",
                                  "q scaled, D=128"])
def test_three_term_bf16_split_is_exact(kind):
    if kind.startswith("q scaled"):
        d = int(kind.split("D=")[1])
        x = _scaled_q(d, seed=d)
    else:
        x = _values(kind)
    hi, mid, lo = _split(x, 3)
    assert torch.equal(_bits(hi + mid + lo), _bits(x))
    for t in (hi, mid, lo):
        assert torch.equal(_bits(_bf16(t)), _bits(t))
    if kind == "q scaled, D=64":
        assert _q_terms(64) == 1
        assert not mid.any() and not lo.any()
    elif kind.startswith("q scaled"):
        assert _q_terms(int(kind.split("D=")[1])) == 3


def test_two_term_split_of_p_leaves_at_most_2_to_the_minus_16_p():
    rng = np.random.default_rng(5)
    p = np.concatenate([np.exp(-rng.uniform(0, 30, size=20000)),
                        1.0 - rng.uniform(0, 1e-3, size=2000), [1.0]])
    p = torch.tensor(p.astype(np.float32))
    hi, lo = _split(p, 2)
    resid = (p.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -16 * p.double()).all())
    assert float((resid / p.double()).max()) > 0       # the split is inexact


def _emulate(q, k, v, *, causal: bool, window: int,
             p_terms: int = 2) -> torch.Tensor:
    """The bf16 route's arithmetic: q (B, H, Sq, D), k and v (B, KV, Sk, D)
    in bf16 -> bf16.  64-row q tiles; the relevant 64-key tiles in order,
    zero-padded past Sk; S as the sum over q terms of (term K^T), each a
    float32 product of bf16 values; the TPU kernel's online softmax in
    float32; PV as the sum over ``p_terms`` bf16 terms of p of (term V)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    nk = -(-Sk // TILE)
    pad = (0, 0, 0, nk * TILE - Sk)
    kf = torch.nn.functional.pad(k.float(), pad).repeat_interleave(H // KV, 1)
    vf = torch.nn.functional.pad(v.float(), pad).repeat_interleave(H // KV, 1)
    x = q.float() * torch.tensor(np.float32(1.0 / math.sqrt(D)))
    qt = _split(x, _q_terms(D))
    out = torch.empty_like(q)
    for q0 in range(0, Sq, TILE):
        rows = slice(q0, min(q0 + TILE, Sq))
        qpos = torch.arange(q0, rows.stop)[:, None]
        m = torch.full((B, H, rows.stop - q0, 1), fa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, rows.stop - q0, D))
        k_end = min(nk, (q0 + TILE - 1) // TILE + 1) if causal else nk
        k_beg = 0
        if window > 0:
            t = q0 - window - TILE + 1
            k_beg = 0 if t < 0 else t // TILE + 1
        for j in range(k_beg, k_end):
            keys = slice(j * TILE, (j + 1) * TILE)
            kpos = torch.arange(keys.start, keys.stop)[None, :]
            s = torch.zeros((B, H, rows.stop - q0, TILE))
            for t in qt:
                s = s + t[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            ok = kpos < Sk
            if causal:
                ok = ok & (kpos <= qpos)
            if window > 0:
                ok = ok & (kpos > qpos - window)
            s = torch.where(ok, s, torch.tensor(fa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha
            for t in _split(p, p_terms):
                acc = acc + t @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def _misses(s: int, d: int, window: int, p_terms: int = 2) -> int:
    """Elements of the emulated route outside the limits against the plain
    version, on GQA 4/2 unit-scale bf16 inputs of sequence ``s``."""
    rng = np.random.default_rng(100 * s + d + window)
    q, k, v = (torch.tensor(rng.normal(size=(2, n, s, d)).astype(np.float32))
               .to(torch.bfloat16) for n in (4, 2, 2))
    got = _emulate(q, k, v, causal=True, window=window, p_terms=p_terms)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    tol = ATTN_F32_TOL + torch.exp2(torch.floor(torch.log2(big)) - 7)
    return int(((got - want).abs() > tol).sum())


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [77, 200])
def test_emulated_route_holds_against_the_plain_version(s, d, window):
    assert _misses(s, d, window) == 0


def test_p_rounded_to_bf16_alone_fails_the_limits():
    """The control: PV with one bf16 term of p (SDPA's rounding) misses
    the limits that the two-term split holds."""
    assert _misses(200, 64, 0, p_terms=1) > 100
