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
kernels in ``csrc/ssd_scan.cu`` (chunk-parallel: every chunk's own state
and the carry over the chunks, then every chunk's output; bf16 on the
tensor cores, float32 on the CUDA cores), on CPU tensors it runs
`ssd_scan_plain`.  Both compute in float32 and write y in x's dtype, h
(B, H, P, N) in float32.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448           # the card's dynamic shared memory per block
MAX_P_BF16, MAX_N_BF16 = 64, 128    # the tensor-core kernels' widest tiles


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
        fn.argtypes = [v] * 10 + [i] * 7 + [ll] * 10 + [v]
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.ssd_scan_smem_bytes.restype = ll
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor, *, chunk: int):
    """x (B, L, H, P); dt (B, L, H); Bm, Cm (B, L, N) or the model's
    (B, L, 1, N); A (H,) float32.  Returns (y (B, L, H, P) in x's dtype,
    h_final (B, H, P, N) float32).

    On the card x, dt, Bm and Cm are float32 or bfloat16, all of one
    dtype, read through their strides (x's, Bm's and Cm's last dim
    contiguous), so the model's views of the conv and in_proj outputs go in
    without a copy; bfloat16 takes P up to 64 and N up to 128; chunk, P and
    N must fit the kernels' shared memory (as the library sizes it,
    ``ssd_scan_smem_bytes``).  The kernels
    carry the chunks' states through a float32 scratch of B × H ×
    ceil(L / chunk) × P × N values, and count each head's chunk states in
    B × H int32."""
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
    if x.dtype == torch.bfloat16 and (P > MAX_P_BF16 or N > MAX_N_BF16):
        raise ValueError(f"ssd_scan: bfloat16 takes P up to {MAX_P_BF16} "
                         f"and N up to {MAX_N_BF16}, got P {P}, N {N}")
    lib = _configure(_build.load("ssd_scan"))
    smem = lib.ssd_scan_smem_bytes(_DTYPES[x.dtype], c, P, N)
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and smem <= MAX_SMEM):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, N {N}, "
                         f"chunk {c} outside the kernel's range (shared "
                         f"memory {smem} > {MAX_SMEM} bytes)")
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
    nc = -(-L // c)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    decays = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    written = torch.zeros((B, H), dtype=torch.int32, device=dev)
    p = _build.ptr
    strides = [*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
               *Cm.stride()[:2]]
    rc = lib.ssd_scan_launch(
        p(x), p(dt), p(Bm), p(Cm), p(A), p(y), p(h), p(states), p(decays),
        p(written), _DTYPES[x.dtype], B, L, H, P, N, c, *strides,
        _build.stream(dev))
    _build.check(rc, lib, "ssd_scan_error_string")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
