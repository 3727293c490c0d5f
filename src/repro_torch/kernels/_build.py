"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in ``csrc/`` compiles on its own into
``build/kernels/lib<name>_<hash>.so`` at the repository root, for
``sm_90a``, with a plain C interface.  The file name carries a hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited kernel is
rebuilt and a stale library is never loaded.  Several sources build in parallel, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("upload_fused", "window_fold", "wire_bytes", "sparsify",
           "ldp_noise", "flash_attention", "selective_scan", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS,
          extra_flags: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns each started
    build's compiler output (``-Xptxas -v`` in ``extra_flags`` makes it
    list registers and spills).  Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def timed_build(names: Iterable[str] = KERNELS,
                extra_flags: Sequence[str] = ()):
    """`build` with its wall time: (seconds, compiler output per source)."""
    t0 = time.perf_counter()
    logs = build(names, extra_flags)
    return time.perf_counter() - t0, logs


def check(rc: int, lib: ctypes.CDLL, fn: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        err = getattr(lib, fn)
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"CUDA launch failed ({rc}): "
                           f"{err(rc).decode()}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a kernel.  A tensor subclass (a
    DTensor: the sharded model calls kernels on each rank's local tensor)
    is refused: its address is not its data's."""
    if t is None:
        return ctypes.c_void_p(0)
    import torch
    if type(t) is not torch.Tensor:
        raise TypeError(f"a kernel takes plain tensors, got "
                        f"{type(t).__name__}")
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``: every kernel launches
    on it."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def aligned(t):
    """``t``, or a fresh copy of it when it does not start on a 16-byte
    boundary (a view with a storage offset): kernels that move rows in
    16-byte runs take no other start."""
    if t is not None and t.data_ptr() % 16:
        return t.clone()
    return t


def require(kernel: str, name: str, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: a kernel takes nothing else."""
    shape = tuple(shape)
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} must be {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
