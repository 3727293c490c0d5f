"""Mamba2 chunked SSD scan (kernel K7).

Port of `repro.kernels.ssd_scan`: for x (B, L, H, P), dt (B, L, H), Bm, Cm
(B, L, N) shared by all heads (n_groups 1) and A (H,), from h_0 = 0,

    h_t = exp(dt_t · A_h) h_{t-1} + (dt_t · x_t) ⊗ B_t,   y_t = h_t · C_t

computed chunk by chunk as the TPU kernel computes it: within a chunk of
``chunk`` steps, lcum = cumsum(dt · A), the diagonal term
y_t = Σ_{s≤t} exp(lcum_t − lcum_s) (C_t·B_s) dt_s x_s, plus the carried
state's term (C_t·h) exp(lcum_t); then the state moves to the chunk's
end.  The caller applies the D-skip and the gated norm, as
`models.ssm.mamba2_fwd` does around its own chunked SSD.

`ssd_scan` keeps the reference's signature without its TPU knobs
(``block_h``, ``interpret``).  ``chunk`` stays: it sets where the state
is carried and so the order of the float32 sums; as in the reference the
chunk is min(chunk, L) and the tail is zero-padded (dt = 0, so a padded
step changes nothing).  On CUDA tensors it launches the hand-written
kernel in ``csrc/ssd_scan.cu``, on CPU tensors it runs `ssd_scan_plain`.
Both compute in float32 and write y in x's dtype, h (B, H, P, N) in
float32.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448           # the card's dynamic shared memory per block


def smem_bytes(c: int, P: int, N: int) -> int:
    """The kernel's shared memory at chunk ``c`` (c, P, N rounded up to
    multiples of 4): C and B transposed (N × c each), dt·x (c × P), the
    state (N × P), the decay-weighted scores (c × c, later B as c × N) and
    three per-step rows, in float32."""
    cp, pp, np_ = (-(-n // 4) * 4 for n in (c, P, N))
    return 4 * (2 * np_ * cp + cp * pp + np_ * pp + cp * max(cp, np_)
                + 3 * cp)


def _groups_to_shared(name: str, t: torch.Tensor) -> torch.Tensor:
    """(B, L, N), or the model's (B, L, G, N) with G = 1, as (B, L, N)."""
    if t.dim() == 4:
        if t.shape[2] != 1:
            raise ValueError(f"ssd_scan: {name} has {t.shape[2]} groups; the "
                             f"kernel shares one B/C across heads "
                             f"(n_groups 1)")
        return t[:, :, 0]
    return t


def _check(x, dt, Bm, Cm, A) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, L, H, P), got "
                         f"{tuple(x.shape)}")
    B, L, H, P = x.shape
    if Bm.dim() != 3:
        raise ValueError(f"ssd_scan: Bm must be (B, L, N), got "
                         f"{tuple(Bm.shape)}")
    N = Bm.shape[2]
    for name, t, shape in (("dt", dt, (B, L, H)), ("Bm", Bm, (B, L, N)),
                           ("Cm", Cm, (B, L, N)), ("A", A, (H,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, *, chunk: int):
    """Plain PyTorch version, chunk by chunk as the TPU kernel computes
    it, all heads at once per chunk.  Returns (y (B, L, H, P) in x's
    dtype, h (B, H, P, N) float32)."""
    B, L, H, P = x.shape
    N = Bm.shape[2]
    c = min(chunk, L)
    nc = -(-L // c)
    pad = nc * c - L
    dev = x.device
    xf = F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(torch.float32), (0, 0, 0, pad))
    Bf = F.pad(Bm.to(torch.float32), (0, 0, 0, pad))
    Cf = F.pad(Cm.to(torch.float32), (0, 0, 0, pad))
    a = A.to(torch.float32)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    y = torch.empty((B, nc * c, H, P), dtype=x.dtype, device=dev)
    for ic in range(nc):
        sl = slice(ic * c, ic * c + c)
        dtc, xc, Bc, Cc = dtf[:, sl], xf[:, sl], Bf[:, sl], Cf[:, sl]
        lcum = torch.cumsum(dtc * a, dim=1)                        # (B,c,H)
        dx = dtc[..., None] * xc                                   # (B,c,H,P)
        scores = torch.einsum("btn,bsn->bts", Cc, Bc)              # (B,c,c)
        decay = torch.exp(lcum[:, :, None, :] - lcum[:, None, :, :])
        M = torch.where(tri[None, :, :, None], decay * scores[..., None],
                        zero)                                      # (B,t,s,H)
        yc = torch.einsum("btsh,bshp->bthp", M, dx)
        yc = yc + torch.einsum("btn,bhpn->bthp", Cc, h) \
            * torch.exp(lcum)[..., None]
        tail = torch.exp(lcum[:, -1:, :] - lcum)                   # (B,c,H)
        h = torch.exp(lcum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bsn,bshp->bhpn", Bc, dx * tail[..., None])
        y[:, sl] = yc.to(x.dtype)
    return y[:, :L], h


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [v] * 7 + [i] * 7 + [ll] * 10 + [v]
        fn.restype = ctypes.c_int
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor, *, chunk: int):
    """x (B, L, H, P); dt (B, L, H); Bm, Cm (B, L, N) or the model's
    (B, L, 1, N); A (H,) float32.  Returns (y (B, L, H, P) in x's dtype,
    h_final (B, H, P, N) float32).

    On the card x, dt, Bm and Cm are float32 or bfloat16, all of one
    dtype, read through their strides (x's, Bm's and Cm's last dim
    contiguous), so the model's views of the conv and in_proj outputs go in
    without a copy; chunk, P and N must fit the kernel's shared memory
    (`smem_bytes`)."""
    Bm, Cm = _groups_to_shared("Bm", Bm), _groups_to_shared("Cm", Cm)
    _check(x, dt, Bm, Cm, A)
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, Bm, Cm, A, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    dev = x.device
    B, L, H, P = x.shape
    N = Bm.shape[2]
    c = min(chunk, L)
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} is not float32 or "
                         f"bfloat16")
    if not (1 <= B <= 65535 and H >= 1 and P >= 1 and N >= 1
            and smem_bytes(c, P, N) <= MAX_SMEM):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, N {N}, "
                         f"chunk {c} outside the kernel's range (shared "
                         f"memory {smem_bytes(c, P, N)} > {MAX_SMEM} bytes)")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev or t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: {name} must be {x.dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan: {name}'s last dim must be "
                             f"contiguous")
    _build.require("ssd_scan", "A", A, (H,), torch.float32, dev)
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    lib = _configure(_build.load("ssd_scan"))
    p = _build.ptr
    strides = [*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
               *Cm.stride()[:2]]
    rc = lib.ssd_scan_launch(
        p(x), p(dt), p(Bm), p(Cm), p(A), p(y), p(h), _DTYPES[x.dtype],
        B, L, H, P, N, c, *strides, _build.stream(dev))
    _build.check(rc, lib, "ssd_scan_error_string")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
