"""Per-row nonzero count of a stacked cohort (kernel K3).

Port of `repro.kernels.wire_bytes`: the count the wire codecs price.
`nnz_fleet` keeps the reference's signature; on CUDA tensors it launches
the hand-written kernel in ``csrc/wire_bytes.cu``, on CPU tensors it runs
`nnz_plain`.  ``x != 0`` is the test: -0.0 is not counted, NaN is.
Besides its launch count, the wrapper tallies the shapes it launched at in
``nnz_fleet.shapes``: (K, N) -> launches.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

THREADS = 512               # the kernel's block
BLOCKS_PER_SM = 2048 // THREADS   # blocks of THREADS an SM holds at once
MIN_CHUNK = 4 * THREADS     # positions a block takes at least when split


class NnzGrid(NamedTuple):
    """How `nnz_fleet` launches: each of the K rows splits over
    ``blocks_per_row`` blocks of ``chunk`` positions (the last shorter);
    ``zeroed``: the blocks of a row add into a zeroed output."""
    blocks_per_row: int
    chunk: int
    zeroed: bool


def nnz_grid(k: int, n: int, sms: int) -> NnzGrid:
    """The launch for a (k, n) cohort on a card of ``sms`` SMs.  Where the
    k rows alone fill one wave of blocks (BLOCKS_PER_SM an SM), one block
    owns a row and writes its count (no zeroed output, no atomics).
    Otherwise each row splits so that the card holds about one wave, in
    blocks of at least MIN_CHUNK positions, a multiple of 4."""
    if k >= BLOCKS_PER_SM * sms:
        return NnzGrid(1, n, False)
    want = -(-BLOCKS_PER_SM * sms // k)             # blocks a row
    chunk = max(MIN_CHUNK, (-(-n // want) + 3) & ~3)
    blocks = -(-n // chunk)
    if blocks == 1:
        return NnzGrid(1, n, False)
    return NnzGrid(blocks, chunk, True)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def nnz_plain(flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (K, N) -> (K,) int32."""
    return (flat != 0).sum(dim=1).to(torch.int32)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.nnz_launch
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, v, i, i, i, i, v]
        fn.restype = ctypes.c_int
    return lib


def nnz_fleet(flat: torch.Tensor) -> torch.Tensor:
    """Per-node nonzero counts of a stacked (K, N) f32 cohort in one
    launch.  Returns (K,) int32 on ``flat``'s device."""
    if flat.device.type == "cpu":
        return nnz_plain(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"wire_bytes: unsupported device {flat.device}")
    k, n = flat.shape
    if not 1 <= k <= 65535 or not 1 <= n < 2 ** 31:
        raise ValueError(f"wire_bytes: shape {(k, n)} outside [1, 65535] x "
                         f"[1, 2^31)")
    _build.require("wire_bytes", "flat", flat, (k, n), torch.float32,
                   flat.device)
    lib = _configure(_build.load("wire_bytes"))
    grid = nnz_grid(k, n, _sm_count(flat.device))
    nnz = (torch.zeros if grid.zeroed else torch.empty)(
        k, dtype=torch.int32, device=flat.device)
    rc = lib.nnz_launch(_build.ptr(flat), _build.ptr(nnz), k, n,
                        grid.blocks_per_row, grid.chunk,
                        _build.stream(flat.device))
    _build.check(rc, lib, "nnz_error_string")
    nnz_fleet.launches += 1
    nnz_fleet.shapes[(k, n)] += 1
    return nnz


nnz_fleet.launches = 0
nnz_fleet.shapes = collections.Counter()
