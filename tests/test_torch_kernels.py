"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held here against the Pallas kernel (interpret mode, as
tests/test_upload_fused.py runs it).  Tolerances:

  * upload_fused: residual', keep set and nnz bitwise; the noised upload
    within 2e-6 · max(1, σS), because `log`/`cos` round differently in XLA
    and in PyTorch's CPU math (measured max |Δ| 4.8e-7);
  * window_fold: bitwise — the plain version computes each gated step as
    fma(a, cur, b·ω), the contraction the compiled reference performs;
  * wire_bytes (K3): equal counts (-0.0 not counted, NaN counted);
  * sparsify (K4): bitwise, compared as int32 views so that -0.0 and +0.0
    are told apart (`==` calls them equal);
  * ldp_noise (K5): within 2e-6 · max(1, σS), for the same log/cos reason
    as upload_fused;
  * the port's fused plain version equals its K4 -> K3 -> K5 plain chain
    bitwise (a fusion, not a numerics change).

The CUDA kernels themselves are held against the same plain versions on
the card by tests/test_torch_cuda.py (skipped without a card) and by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accumulator as jacc
from repro.kernels import ldp_noise as jldp
from repro.kernels import sparsify as jsp
from repro.kernels.upload_fused import upload_fused_fleet as j_upload
from repro.kernels.window_fold import window_fold_fleet as j_fold
from repro.kernels.wire_bytes import nnz_fleet as j_nnz
from repro_torch.kernels import ldp_noise as ldp
from repro_torch.kernels import sparsify as sp
from repro_torch.kernels import upload_fused as uf
from repro_torch.kernels import window_fold as wf
from repro_torch.kernels import wire_bytes as wb


def _cohort(k, sizes, seed):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    flat = rng.normal(size=(k, n)).astype(np.float32)
    res = rng.normal(size=(k, n)).astype(np.float32)
    offs = tuple(int(b) for b in np.cumsum((0,) + tuple(sizes))[:-1])
    return flat, res, offs


def _inputs(k, sizes, ratio, sigma, seed):
    flat, res, offs = _cohort(k, sizes, seed)
    n = flat.shape[1]
    do_sp = ratio < 1.0
    thr = None
    if do_sp:
        ends = list(offs[1:]) + [n]
        comb = flat + res
        thr = np.stack([np.asarray(jax.vmap(
            lambda v: jacc.leaf_threshold(v, ratio))(jnp.asarray(
                comb[:, o:e]))) for o, e in zip(offs, ends)], axis=1)
    seeds = np.arange(11, 11 + k).astype(np.int32)
    seeds[0] = -7                       # negative seeds wrap like int32
    scales = (np.random.default_rng(seed).random(k).astype(np.float32)
              + 0.5) if sigma > 0 else None
    return (flat, res if do_sp else None, thr, seeds, scales, sigma,
            1.3), offs


def _run_both(args, offs):
    conv = lambda f: tuple(None if a is None else f(a)
                           if isinstance(a, np.ndarray) else a for a in args)
    ref = j_upload(*conv(jnp.asarray), boundaries=offs, need_nnz=True)
    out = uf.upload_fused_fleet(*conv(torch.tensor), boundaries=offs,
                                need_nnz=True)
    return ref, out


@pytest.mark.parametrize("ratio,sigma", [(0.3, 0.0), (1.0, 0.5),
                                         (0.3, 0.5)])
@pytest.mark.parametrize("k,sizes", [(4, (700, 1301, 96)),
                                     (1, (150000, 120001))])
def test_upload_fused_plain_matches_pallas_kernel(ratio, sigma, k, sizes):
    """(700, 1301, 96): awkward leaf layout; one node row with P =
    270,001 > 262,144 crosses into the TPU kernel's second noise tile."""
    args, offs = _inputs(k, sizes, ratio, sigma, seed=k)
    (uj, rj, nj), (ut, rt, nt) = _run_both(args, offs)
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    if ratio < 1.0:
        np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
        np.testing.assert_array_equal(np.asarray(uj) != 0, ut.numpy() != 0)
    tol = 2e-6 * max(1.0, sigma * 1.3)
    np.testing.assert_allclose(np.asarray(uj), ut.numpy(), rtol=0, atol=tol)


def test_block_noise_tiles_follow_flat_position():
    """Position p of a row draws from tile p // 2^18 at in-tile index
    p % 2^18: the second tile's stream is the first tile's with the seed
    advanced by 7919."""
    seeds = torch.tensor([5, 5 + 7919], dtype=torch.int32)
    noise = ldp.block_noise(seeds, ldp.TILE + 100, 0.5)
    torch.testing.assert_close(noise[0, ldp.TILE:], noise[1, :100],
                               rtol=0, atol=0)


@pytest.mark.parametrize("pattern", ["all", "none", "alternate", "random"])
def test_window_fold_plain_matches_pallas_kernel_bitwise(pattern):
    rng = np.random.default_rng(len(pattern))
    c, n = 9, 3000
    gates = {"all": np.ones(c, bool), "none": np.zeros(c, bool),
             "alternate": np.arange(c) % 2 == 0,
             "random": rng.random(c) < 0.6}[pattern]
    p = rng.normal(size=n).astype(np.float32)
    om = rng.normal(size=(c, n)).astype(np.float32)
    tau = rng.integers(0, 6, c).astype(np.float32)
    b = (0.5 * (tau + 1.0) ** -0.5).astype(np.float32)
    a = (np.float32(1.0) - b).astype(np.float32)
    fj, sj = j_fold(*(jnp.asarray(x) for x in (p, om, gates, a, b)))
    ft, st = wf.window_fold_fleet(*(torch.tensor(x)
                                    for x in (p, om, gates, a, b)))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


def _counts():
    return (uf.upload_fused_fleet.launches, wf.window_fold_fleet.launches,
            wb.nnz_fleet.launches, sp.sparsify_fleet.launches,
            ldp.ldp_perturb_fleet.launches)


def test_cpu_tensors_never_touch_launch_counters():
    before = _counts()
    args, offs = _inputs(2, (50, 30), 0.3, 0.5, seed=0)
    _run_both(args, offs)
    wf.window_fold_fleet(torch.zeros(8), torch.ones(3, 8),
                         torch.tensor([1, 0, 1]), torch.full((3,), 0.5),
                         torch.full((3,), 0.5))
    x = torch.ones(3, 8)
    wb.nnz_fleet(x)
    sp.sparsify_fleet(x, x, torch.ones(3))
    sp.sparsify_flat(x[0], x[0], torch.tensor(1.0))
    ldp.ldp_perturb_fleet(x, torch.arange(3, dtype=torch.int32),
                          torch.ones(3), 0.5, 1.0)
    ldp.ldp_perturb_flat(x[0], torch.tensor(3, dtype=torch.int32),
                         torch.tensor(1.0), 0.5, 1.0)
    assert _counts() == before


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on neither the CPU nor a CUDA device
    is refused, not computed some other way."""
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        uf.upload_fused_fleet(meta, None, None, None, None, 0.0, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        wf.window_fold_fleet(torch.empty(8, device="meta"), meta,
                             torch.ones(2), torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="unsupported device"):
        wb.nnz_fleet(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sp.sparsify_fleet(meta, meta, torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ldp.ldp_perturb_fleet(meta, None, None, 0.5, 1.0)


# ---------------------------------------------------------------------------
# K3 nnz_fleet, K4 sparsify, K5 ldp_noise
# ---------------------------------------------------------------------------

def _mixed_rows(k, n, seed):
    """Rows of mixed sparsity with -0.0 and NaN entries planted."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, n)).astype(np.float32)
    for i in range(k):
        keep = rng.random(n) < [0.0, 1e-3, 0.1, 0.5, 1.0][i % 5]
        x[i, ~keep] = 0.0
    x[0, 3] = -0.0
    x[-1, 5] = -0.0
    x[-1, 11] = np.nan
    return x


@pytest.mark.parametrize("k,n", [(5, 3000), (2, 300001)])
def test_nnz_plain_matches_pallas_kernel(k, n):
    x = _mixed_rows(k, n, seed=n)
    np.testing.assert_array_equal(wb.nnz_fleet(torch.tensor(x)).numpy(),
                                  np.asarray(j_nnz(jnp.asarray(x))))


def _split_inputs(k, n, seed):
    """g, r and thresholds with exact ties |c| == thr and a row of
    c = -0.0 at thr = 0 (kept, uploaded as -0.0)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(k, n)).astype(np.float32)
    r = rng.normal(size=(k, n)).astype(np.float32)
    c = g + r
    thr = np.abs(c[:, 7]).astype(np.float32)     # element 7 ties
    g[0, :10] = -0.0
    r[0, :10] = -0.0
    thr[0] = 0.0
    return g, r, thr


def _bits(x):
    return torch.tensor(np.array(x, np.float32)).view(torch.int32)


@pytest.mark.parametrize("k,n", [(4, 3000), (2, 2049)])
def test_sparsify_plain_matches_pallas_kernel_bitwise(k, n):
    g, r, thr = _split_inputs(k, n, seed=k)
    uj, rj = jsp.sparsify_fleet(*(jnp.asarray(a) for a in (g, r, thr)))
    ut, rt = sp.sparsify_fleet(*(torch.tensor(a) for a in (g, r, thr)))
    assert torch.equal(_bits(uj), ut.view(torch.int32))
    assert torch.equal(_bits(rj), rt.view(torch.int32))
    assert bool(ut[0, 0].signbit()) and float(ut[0, 0]) == 0.0
    assert float(ut[k - 1, 7]) != 0.0                   # a tie is kept
    uj1, rj1 = jsp.sparsify_flat(jnp.asarray(g[0]), jnp.asarray(r[0]),
                                 jnp.asarray(thr[0]))
    ut1, rt1 = sp.sparsify_flat(torch.tensor(g[0]), torch.tensor(r[0]),
                                torch.tensor(thr[0]))
    assert torch.equal(_bits(uj1), ut1.view(torch.int32))
    assert torch.equal(_bits(rj1), rt1.view(torch.int32))


@pytest.mark.parametrize("sigma", [0.0, 0.05, 0.7])
@pytest.mark.parametrize("k,n", [(3, 2000), (2, 270001)])
def test_ldp_perturb_plain_matches_pallas_kernel(k, n, sigma):
    """(2, 270,001) crosses into the second noise tile (P > 262,144)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(k, n)).astype(np.float32)
    seeds = rng.integers(-2 ** 31, 2 ** 31, k).astype(np.int32)
    scales = (rng.random(k) + 0.5).astype(np.float32)
    clip_s = 1.3
    tol = 2e-6 * max(1.0, sigma * clip_s)
    yj = jldp.ldp_perturb_fleet(jnp.asarray(x), jnp.asarray(seeds),
                                jnp.asarray(scales), sigma, clip_s)
    yt = ldp.ldp_perturb_fleet(torch.tensor(x), torch.tensor(seeds),
                               torch.tensor(scales), sigma, clip_s)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=tol)
    fj = jldp.ldp_perturb_flat(jnp.asarray(x[1]), jnp.asarray(seeds[1]),
                               jnp.asarray(scales[1]), sigma, clip_s)
    ft = ldp.ldp_perturb_flat(torch.tensor(x[1]), torch.tensor(seeds[1]),
                              torch.tensor(scales[1]), sigma, clip_s)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=tol)
    assert torch.equal(ft, yt[1])


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_fused_plain_equals_the_unfused_plain_chain_bitwise(sigma):
    """K1's plain version against K4 -> K3 -> K5 plain on one cohort with
    the same thresholds, seeds and clip scales: upload, residual' and nnz
    bit for bit (mirrors tests/test_upload_fused.py's fused-vs-chain)."""
    k, n = 4, 3000
    g, r, _ = _split_inputs(k, n, seed=9)
    g, r = torch.tensor(g), torch.tensor(r)
    thr = torch.tensor(np.quantile(np.abs((g + r).numpy()), 0.8, axis=1)
                       .astype(np.float32))
    up4, r4 = sp.sparsify_fleet(g, r, thr)
    nnz3 = wb.nnz_fleet(up4)
    scales = 1.0 / torch.clamp(torch.sqrt((up4 * up4).sum(1)), min=1.0)
    seeds = torch.tensor([-7, 11, 2 ** 31 - 1, 0], dtype=torch.int32)
    up5 = ldp.ldp_perturb_fleet(up4, seeds, scales, sigma, 1.0)
    up1, r1, nnz1 = uf.upload_fused_fleet(
        g, r, thr[:, None], seeds, scales, sigma, 1.0, boundaries=(0,),
        need_nnz=True)
    assert torch.equal(up1.view(torch.int32), up5.view(torch.int32))
    assert torch.equal(r1.view(torch.int32), r4.view(torch.int32))
    assert torch.equal(nnz1, nnz3)

