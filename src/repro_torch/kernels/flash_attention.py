"""Blocked causal / sliding-window GQA flash attention (kernel K6).

Port of `repro.kernels.flash_attention`.  `flash_attention` keeps the
reference's signature (q (B, H, Sq, D); k, v (B, KV, Sk, D); head h reads
KV head h // (H // KV)); on CUDA tensors it launches the hand-written
kernel in ``csrc/flash_attention.cu``, on CPU tensors it runs
`flash_attention_plain`.

Both compute what the TPU kernel computes: q, k and v in float32, q
scaled by float32(1/√D) before QKᵀ, masked scores set to −1e30 (not −inf:
a row whose first relevant block is all masked gathers exp(0) = 1 until a
real key makes the rescale exp(−1e30 − m) exactly 0), an online softmax
with m, l and the accumulator in float32, kv blocks that are masked for
the whole q block skipped, and the output acc / max(l, 1e-30) cast to q's
dtype.  The plain version walks the reference's (128, 128) blocks; the
CUDA kernel uses (64, 64) tiles.  Skipping or computing a block that is
masked for a row changes nothing once that row has a real key, so the two
differ only in the order of float32 sums.  The kernel runs bf16 inputs on
the tensor cores, with q·scale split into bf16 terms that sum to it
exactly (QKᵀ keeps the float32 computation's products) and p into two
terms that miss it by at most 2⁻¹⁶·p, and float32 inputs on the CUDA
cores.  The tensor cores add those products with their own alignment and
truncation, not in IEEE float32, so on that route the sums also round
differently; the checks on the card bound the difference.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128          # the CUDA kernel's widest tile
BLOCK = 128                 # the TPU kernel's default q and kv block


def _scale(d: int) -> torch.Tensor:
    """float32(1/√D), the constant the reference multiplies q by."""
    return torch.tensor(np.float32(1.0 / math.sqrt(d)))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain PyTorch version, block by block as the TPU kernel runs:
    blocks shrunk to max(S, 8) for short sequences, q/k/v zero-padded to
    whole blocks, all (b, h) at once for each (q block, kv block) pair."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    bq = min(BLOCK, max(Sq, 8))
    bk = min(BLOCK, max(Sk, 8))
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    dev = q.device
    qf = F.pad(q.to(torch.float32), (0, 0, 0, nq * bq - Sq))
    qf = qf * _scale(D).to(dev)
    kf = F.pad(k.to(torch.float32), (0, 0, 0, nk * bk - Sk))
    vf = F.pad(v.to(torch.float32), (0, 0, 0, nk * bk - Sk))
    kf = kf.repeat_interleave(G, dim=1)
    vf = vf.repeat_interleave(G, dim=1)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    out = torch.empty((B, H, nq * bq, D), dtype=q.dtype, device=dev)
    for iq in range(nq):
        first_q, last_q = iq * bq, iq * bq + bq - 1
        qb = qf[:, :, first_q:first_q + bq]
        qpos = torch.arange(first_q, first_q + bq, device=dev)[:, None]
        m = torch.full((B, H, bq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, bq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=dev)
        for ik in range(nk):
            first_k, last_k = ik * bk, ik * bk + bk - 1
            if causal and first_k > last_q:
                continue
            if window > 0 and not last_k > first_q - window:
                continue
            kpos = torch.arange(first_k, first_k + bk, device=dev)[None, :]
            s = qb @ kf[:, :, first_k:first_k + bk].transpose(-1, -2)
            mask = kpos < Sk
            if causal:
                mask = mask & (kpos <= qpos)
            if window > 0:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, first_k:first_k + bk]
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        out[:, :, first_q:first_q + bq] = (acc / lc).to(q.dtype)
    return out[:, :, :Sq]


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([v, v, v, v, i] + [i] * 6 + [ll] * 12
                       + [i, i, ctypes.c_float, v])
        fn.restype = ctypes.c_int
    return lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    out: torch.Tensor = None) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KV, Sk, D) -> (B, H, Sq, D) in q's dtype.

    The CUDA kernel reads its inputs through their strides (the head dim
    must be contiguous), so the model layout's transposed views go in
    without a copy; ``out``, a (B, H, Sq, D) tensor or view of q's dtype,
    receives the result in place of a fresh tensor."""
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, window=window)
        if out is None:
            return o
        out.copy_(o)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    dev = q.device
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")
    if not 1 <= D <= MAX_HEAD_DIM or KV < 1 or H % KV or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} outside the kernel's range "
                         f"(D <= {MAX_HEAD_DIM}, H % KV == 0)")
    if out is None:
        out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=dev)
    for name, t, shape in (("k", k, (B, KV, Sk, D)), ("v", v, (B, KV, Sk, D)),
                           ("out", out, (B, H, Sq, D))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous")
    lib = _configure(_build.load("flash_attention"))
    p = _build.ptr
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_launch(
        p(q), p(k), p(v), p(out), _DTYPES[q.dtype], B, H, KV, Sq, Sk, D,
        *strides, int(causal), int(window), float(_scale(D)),
        _build.stream(dev))
    _build.check(rc, lib, "flash_attention_error_string")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
