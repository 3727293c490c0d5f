"""Kernel K6 (flash attention) of the port against the reference's Pallas
kernel.

On the CPU `flash_attention` runs `flash_attention_plain`, which is held
here against `repro.kernels.flash_attention.flash_attention` in interpret
mode (as tests/test_kernels.py runs it) on the same numpy inputs.
Tolerances:

  * float32: 2e-6 absolute at unit-scale inputs.  Both compute in float32
    with the same blocks, masks, −1e30 and clamp; XLA's and PyTorch's
    CPU matmuls sum in different orders (measured max |Δ| 7.2e-7).
  * bfloat16: the same float32 arithmetic, rounded once to bfloat16 at the
    end; two float32 values within 2e-6 round to bfloat16 values within
    2e-6 plus one bfloat16 ulp of the larger (ulp(x) = 2^(⌊log2|x|⌋ − 7)).

The CUDA kernel is held against the same plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ops import attention_pallas as j_attention_pallas
from repro_torch import convert
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.ops import attention_pallas

F32_TOL = 2e-6


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _inputs(seed, B, H, KV, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, n, s, D)).astype(np.float32)
            for n, s in ((H, Sq), (KV, Sk), (KV, Sk))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [convert.to_torch({"x": a})["x"] for a in jx]
    return jx, tx


def _assert_close(got: torch.Tensor, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want)
    if dtype == jnp.float32:
        assert err.max() <= F32_TOL, err.max()
    else:
        tol = F32_TOL + _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (err <= tol).all(), (err - tol).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("sq", [5, 100, 300])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0), (False, 40)])
def test_flash_plain_matches_pallas(causal, window, group, sq, dtype):
    """Sq 5 (blocks shrunk to the 8-row floor), 100 (one padded block),
    300 (three blocks, the last padded; window 40 skips whole kv blocks
    and leaves rows whose first relevant block is all masked)."""
    B, KV, D = 2, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq, B, KV * group, KV, sq, sq, D,
                                         dtype)
    want = j_flash(jq, jk, jv, causal=causal, window=window)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    _assert_close(got, want, dtype)


def test_flash_plain_keys_longer_than_queries():
    """Sk ≠ Sq (non-causal, as cross attention would call it), D = 80."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, 1, 4, 2, 37, 150, 80,
                                         jnp.float32)
    want = j_flash(jq, jk, jv, causal=False)
    _assert_close(tfa.flash_attention_plain(tq, tk, tv, causal=False), want,
                  jnp.float32)


def test_flash_wrapper_on_cpu_runs_plain_and_counts_nothing():
    (_, _, _), (tq, tk, tv) = _inputs(1, 1, 3, 1, 20, 20, 16, jnp.float32)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=6)
    want = tfa.flash_attention_plain(tq, tk, tv, causal=True, window=6)
    assert torch.equal(got, want)
    out = torch.empty_like(tq)
    assert tfa.flash_attention(tq, tk, tv, out=out) is out
    assert torch.equal(out, tfa.flash_attention_plain(tq, tk, tv))
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_attention_pallas_model_layout(causal, window, dtype):
    rng = np.random.default_rng(3)
    shapes = ((2, 48, 6, 16), (2, 48, 2, 16), (2, 48, 2, 16))
    jx = [jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(dtype)
          for s in shapes]
    tx = [convert.to_torch({"x": a})["x"] for a in jx]
    want = j_attention_pallas(*jx, causal=causal, window=window)
    got = attention_pallas(*tx, causal=causal, window=window)
    assert got.shape == (2, 48, 6, 16) and got.is_contiguous()
    _assert_close(got, want, dtype)
