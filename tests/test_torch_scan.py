"""The scan kernels K8 (selective_scan) and K7 (ssd_scan) in the port
against the reference's Pallas kernels.

The same numpy inputs go through `repro.kernels.{selective_scan,ssd_scan}`
(Pallas in interpret mode on the CPU, as tests/test_kernels.py runs them),
their sequential oracles in `repro.kernels.ref`, and the port's wrappers,
which on CPU tensors run their plain versions.  Shapes are those of
tests/test_kernels.py, ragged cases included, with K7's chunk as given
there.

Tolerance: 1e-4 absolute and relative, as tests/test_kernels.py holds the
kernels to their oracles (the readings are under 3e-6 at values up to
about 12: the kernels sum in other orders, and `exp` differs by an ulp
between XLA and PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import selective_scan_ref, ssd_scan_ref
from repro.kernels.selective_scan import selective_scan as j_selective_scan
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro_torch.kernels import selective_scan as ts
from repro_torch.kernels import ssd_scan as td
from repro_torch.models import ssm as tssm

TOL = dict(rtol=1e-4, atol=1e-4)


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _k8_inputs(seed, B, L, D, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, L, D))) * np.float32(0.1)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    A = -np.exp(rng.normal(size=(D, N)) * 0.2).astype(np.float32)
    return x, dt, Bm, Cm, A


def _k7_inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, L, H))) * np.float32(0.2)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.3).astype(np.float32)
    return x, dt, Bm, Cm, A


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,L,D,N,bl,bd", [
    (2, 32, 16, 4, 8, 8),
    (1, 50, 24, 8, 16, 16),     # ragged L/D, needs padding
    (2, 64, 64, 16, 32, 32),
    (1, 33, 8, 16, 64, 64),     # blocks larger than dims
])
def test_selective_scan_plain_matches_pallas_kernel(B, L, D, N, bl, bd):
    args = _k8_inputs(B * 1000 + L, B, L, D, N)
    y_k, h_k = j_selective_scan(*(jnp.asarray(a) for a in args),
                                block_l=bl, block_d=bd)
    y_r, h_r = selective_scan_ref(*(jnp.asarray(a) for a in args))
    before = ts.selective_scan.launches
    y, h = ts.selective_scan(*(torch.as_tensor(a) for a in args))
    assert ts.selective_scan.launches == before          # CPU: plain
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for got, want in ((y, y_k), (h, h_k), (y, y_r), (h, h_r)):
        _close(got, want)


def test_selective_scan_matches_model_ssm():
    """K8 (its plain version here) == the port model's chunked Mamba1
    recurrence (`models.ssm._m1_scan_chunk`, pre-gating)."""
    B, L, D, N = 1, 16, 8, 4
    x, dt, Bm, Cm, A = (torch.as_tensor(a)
                        for a in _k8_inputs(1, B, L, D, N))
    y, h = ts.selective_scan(x, dt, Bm, Cm, A)
    la = dt[..., None] * A
    bx = (dt * x)[..., None] * Bm[:, :, None, :]
    h_all, h_last = tssm._m1_scan_chunk(torch.zeros(B, D, N), la, bx)
    y_model = torch.einsum("bldn,bln->bld", h_all, Cm)
    _close(y, y_model)
    _close(h, h_last)


@pytest.mark.parametrize("B,L,H,P,N,c,bh", [
    (1, 32, 4, 8, 16, 8, 2),
    (2, 48, 8, 16, 8, 16, 4),
    (1, 50, 6, 8, 32, 64, 8),    # ragged L/H, blocks > dims
])
def test_ssd_scan_plain_matches_pallas_kernel(B, L, H, P, N, c, bh):
    args = _k7_inputs(B * 1000 + L, B, L, H, P, N)
    y_k, h_k = j_ssd_scan(*(jnp.asarray(a) for a in args), chunk=c,
                          block_h=bh)
    y_r, h_r = ssd_scan_ref(*(jnp.asarray(a) for a in args))
    before = td.ssd_scan.launches
    y, h = td.ssd_scan(*(torch.as_tensor(a) for a in args), chunk=c)
    assert td.ssd_scan.launches == before                 # CPU: plain
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for got, want in ((y, y_k), (h, h_k), (y, y_r), (h, h_r)):
        _close(got, want)


@pytest.mark.parametrize("c", [4, 5, 16])
def test_ssd_scan_matches_model_mamba2(c):
    """K7 (its plain version here) == the port model's chunked SSD
    (`models.ssm._m2_chunked_scan`, groups broadcast to heads) at the same
    chunk, whole and ragged, and the model's (B, L, 1, N) B/C go in as
    they are."""
    B, L, H, P, N = 1, 16, 4, 8, 8
    x, dt, Bm, Cm, A = (torch.as_tensor(a)
                        for a in _k7_inputs(2, B, L, H, P, N))
    y, h = td.ssd_scan(x, dt, Bm[:, :, None], Cm[:, :, None], A, chunk=c)
    Bh = Bm[:, :, None].expand(B, L, H, N)
    Ch = Cm[:, :, None].expand(B, L, H, N)
    y_m, h_m = tssm._m2_chunked_scan(x, dt, Bh, Ch, A, c,
                                     torch.zeros(B, H, P, N), torch.float32)
    _close(y, y_m)
    _close(h, h_m)


def test_wrappers_refuse_groups_and_mismatched_shapes():
    x, dt, Bm, Cm, A = (torch.as_tensor(a) for a in _k7_inputs(3, 1, 8, 4,
                                                                2, 4))
    two = Bm[:, :, None].expand(1, 8, 2, 4)
    with pytest.raises(ValueError, match="groups"):
        td.ssd_scan(x, dt, two, two, A, chunk=4)
    with pytest.raises(ValueError, match="dt must be"):
        td.ssd_scan(x, dt[:, :7], Bm, Cm, A, chunk=4)
    with pytest.raises(ValueError, match="A must be"):
        td.ssd_scan(x, dt, Bm, Cm, A[:3], chunk=4)
    with pytest.raises(ValueError, match="Cm must be"):
        td.ssd_scan(x, dt, Bm, Cm[..., :3], A, chunk=4)
    with pytest.raises(ValueError, match="chunk"):
        td.ssd_scan(x, dt, Bm, Cm, A, chunk=0)
    x, dt, Bm, Cm, A = (torch.as_tensor(a) for a in _k8_inputs(3, 1, 8, 6,
                                                                4))
    with pytest.raises(ValueError, match="A must be"):
        ts.selective_scan(x, dt, Bm, Cm, A[:5])
    with pytest.raises(ValueError, match="Bm must be"):
        ts.selective_scan(x, dt, Bm[:, :7], Cm, A)
    with pytest.raises(ValueError, match="dt must be"):
        ts.selective_scan(x, dt[..., :5], Bm, Cm, A)
    with pytest.raises(ValueError, match="x must be"):
        ts.selective_scan(x[0], dt, Bm, Cm, A)
