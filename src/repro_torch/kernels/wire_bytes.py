"""Per-row nonzero count of a stacked cohort (kernel K3).

Port of `repro.kernels.wire_bytes`: the count the wire codecs price.
`nnz_fleet` keeps the reference's signature; on CUDA tensors it launches
the hand-written kernel in ``csrc/wire_bytes.cu``, on CPU tensors it runs
`nnz_plain`.  ``x != 0`` is the test: -0.0 is not counted, NaN is.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def nnz_plain(flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (K, N) -> (K,) int32."""
    return (flat != 0).sum(dim=1).to(torch.int32)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.nnz_launch
    if fn.argtypes is None:
        v = ctypes.c_void_p
        fn.argtypes = [v, v, ctypes.c_int, ctypes.c_longlong, v]
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
    if not 1 <= k <= 65535 or n < 1:
        raise ValueError(f"wire_bytes: shape {(k, n)} outside [1, 65535] x "
                         f"[1, ...)")
    _build.require("wire_bytes", "flat", flat, (k, n), torch.float32,
                   flat.device)
    lib = _configure(_build.load("wire_bytes"))
    nnz = torch.zeros(k, dtype=torch.int32, device=flat.device)
    rc = lib.nnz_launch(
        _build.ptr(flat), _build.ptr(nnz), k, n, _build.stream(flat.device))
    _build.check(rc, lib, "nnz_error_string")
    nnz_fleet.launches += 1
    return nnz


nnz_fleet.launches = 0
