"""Device meshes over the default `torch.distributed` process group.

Port of `repro.launch.mesh`.  Importing this module touches no device
and no process group; meshes are built inside functions only.

  make_production_mesh(multi_pod=False)  (data 16, model 16), 256 ranks
  make_production_mesh(multi_pod=True)   (pod 2, data 16, model 16), 512
  make_host_mesh(data, model)            (data, model), any size

Each is a `DeviceMesh` with the reference's axis names, over an
initialised default group whose world size must equal the mesh's size:
a mismatch raises ValueError (there is no fallback to fewer devices).
The device type is "cuda" unless the caller asks for "cpu" (a gloo
group, or the fake group of a dry run).

`fake_world(n)` opens a "fake" process group of n ranks in this one
process (PyTorch's `FakeStore`): collectives return at once and move no
data, so a dry run can build the 256- and 512-rank meshes and trace a
step's per-rank work and collectives on one CPU.
"""
from __future__ import annotations

import contextlib
from typing import Tuple


def _dist():
    import torch.distributed as dist
    return dist


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    dist = _dist()
    n = 1
    for s in shape:
        n *= s
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            "torch.distributed default process group of "
            f"{n} ranks: call torch.distributed.init_process_group("
            "backend ('nccl' on CUDA, 'gloo' on the CPU), init_method="
            "'tcp://localhost:<port>' or 'file://<path>', world_size=, "
            "rank=) in every rank's process first (launch.mesh.fake_world "
            "for a dry run)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"mesh {dict(zip(names, shape))} needs {n} ranks but the "
            f"process group has {world}; start one process per device "
            f"with world_size={n}")
    if device_type == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise ValueError("a cuda mesh needs a CUDA device; pass "
                             "device_type='cpu' for a gloo or fake group")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data 16, model 16), 256 ranks.  Multi-pod:
    (pod 2, data 16, model 16), 512 ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the default group's data × model ranks."""
    return _mesh((int(data), int(model)), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A "fake" default process group of ``world_size`` ranks in this
    process, destroyed on exit.  Raises when a group is already open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist = _dist()
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
