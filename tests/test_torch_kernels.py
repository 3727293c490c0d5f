"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held here against the Pallas kernel (interpret mode, as
tests/test_upload_fused.py runs it).  Tolerances:

  * upload_fused: residual', keep set and nnz bitwise; the noised upload
    within 2e-6 · max(1, σS), because `log`/`cos` round differently in XLA
    and in PyTorch's CPU math (measured max |Δ| 4.8e-7);
  * window_fold: bitwise — the plain version computes each gated step as
    fma(a, cur, b·ω), the contraction the compiled reference performs.

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
from repro.kernels.upload_fused import upload_fused_fleet as j_upload
from repro.kernels.window_fold import window_fold_fleet as j_fold
from repro_torch.kernels import upload_fused as uf
from repro_torch.kernels import window_fold as wf


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
    noise = uf.block_noise(seeds, uf.TILE + 100, 0.5)
    torch.testing.assert_close(noise[0, uf.TILE:], noise[1, :100],
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


def test_cpu_tensors_never_touch_launch_counters():
    before = (uf.upload_fused_fleet.launches, wf.window_fold_fleet.launches)
    args, offs = _inputs(2, (50, 30), 0.3, 0.5, seed=0)
    _run_both(args, offs)
    wf.window_fold_fleet(torch.zeros(8), torch.ones(3, 8),
                         torch.tensor([1, 0, 1]), torch.full((3,), 0.5),
                         torch.full((3,), 0.5))
    assert (uf.upload_fused_fleet.launches,
            wf.window_fold_fleet.launches) == before


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on neither the CPU nor a CUDA device
    is refused, not computed some other way."""
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        uf.upload_fused_fleet(meta, None, None, None, None, 0.0, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        wf.window_fold_fleet(torch.empty(8, device="meta"), meta,
                             torch.ones(2), torch.ones(2), torch.ones(2))

