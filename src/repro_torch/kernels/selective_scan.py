"""Mamba1 selective scan (kernel K8).

Port of `repro.kernels.selective_scan`:

    h_t = exp(dt_t · A) ∘ h_{t-1} + (dt_t · x_t) ⊗ B_t,   y_t = h_t · C_t

for x, dt (B, L, D), Bm, Cm (B, L, N), A (D, N), from h_0 = 0.  The caller
applies the D-skip and the gating, as `models.ssm.mamba1_fwd` does around
its own chunked scan.  `selective_scan` keeps the reference's signature
without its TPU tiling knobs (``block_l``, ``block_d``, ``interpret``);
on CUDA tensors it launches the hand-written kernel in
``csrc/selective_scan.cu``, on CPU tensors it runs `selective_scan_plain`,
the sequential recurrence of the reference's `selective_scan_ref`.

Both compute in float32 (inputs converted exactly) and write y in x's
dtype and the final state h (B, D, N) in float32.  The kernel rounds the
state update as the plain version does (a product, a product, a sum), so
the two differ only in `expf` against PyTorch's exp and in the order of
the N-term sum of y.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256             # the widest N the kernel's lane layout takes


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, A: torch.Tensor):
    """Plain PyTorch version: the sequential recurrence in float32, one
    time step at a time.  Returns (y (B, L, D) in x's dtype, h (B, D, N)
    float32)."""
    B, L, D = x.shape
    xf, dtf, Bf, Cf = (t.to(torch.float32) for t in (x, dt, Bm, Cm))
    Af = A.to(torch.float32)
    h = torch.zeros((B, D, A.shape[1]), dtype=torch.float32, device=x.device)
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    for t in range(L):
        decay = torch.exp(dtf[:, t, :, None] * Af)                 # (B,D,N)
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] \
            * Bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t]).to(x.dtype)
    return y, h


def _check(x, dt, Bm, Cm, A) -> None:
    """Raise on shapes that do not fit together."""
    if x.dim() != 3:
        raise ValueError(f"selective_scan: x must be (B, L, D), got "
                         f"{tuple(x.shape)}")
    B, L, D = x.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"selective_scan: A must be ({D}, N), got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    for name, t, shape in (("dt", dt, (B, L, D)), ("Bm", Bm, (B, L, N)),
                           ("Cm", Cm, (B, L, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.selective_scan_launch
    if fn.argtypes is None:
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [v] * 7 + [i] * 5 + [ll] * 8 + [v]
        fn.restype = ctypes.c_int
    return lib


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor):
    """x, dt (B, L, D); Bm, Cm (B, L, N); A (D, N) float32.

    Returns (y (B, L, D) in x's dtype, h_final (B, D, N) float32).  On the
    card x, dt, Bm and Cm are float32 or bfloat16, all of one dtype, read
    through their strides (the last dim contiguous), so the model's views
    of the x_proj output go in without a copy; N is a power of two up to
    256."""
    _check(x, dt, Bm, Cm, A)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, Bm, Cm, A)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    dev = x.device
    B, L, D = x.shape
    N = A.shape[1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"selective_scan: dtype {x.dtype} is not float32 "
                         f"or bfloat16")
    if not (1 <= B <= 65535 and L >= 1 and D >= 1 and N <= MAX_STATE
            and N >= 1 and N & (N - 1) == 0):
        raise ValueError(f"selective_scan: shapes x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)} outside the kernel's range "
                         f"(N a power of two <= {MAX_STATE})")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"selective_scan: {name} must be {x.dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(2) != 1 and t.shape[2] > 1:
            raise ValueError(f"selective_scan: {name}'s last dim must be "
                             f"contiguous")
    _build.require("selective_scan", "A", A, (D, N), torch.float32, dev)
    y = torch.empty((B, L, D), dtype=x.dtype, device=dev)
    h = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    lib = _configure(_build.load("selective_scan"))
    p = _build.ptr
    strides = [s for t in (x, dt, Bm, Cm) for s in t.stride()[:2]]
    rc = lib.selective_scan_launch(
        p(x), p(dt), p(Bm), p(Cm), p(A), p(y), p(h), _DTYPES[x.dtype],
        B, L, D, N, *strides, _build.stream(dev))
    _build.check(rc, lib, "selective_scan_error_string")
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
