"""FleetMesh: the fleet's node axis sharded over a torch.distributed group.

Port of `repro.fleet.mesh`.  Both fleet engines keep every per-node
quantity (residuals, data shards, dispatched models, virtual clocks)
stacked on a leading node axis.  `FleetMesh` splits that axis over the
ranks of the default `torch.distributed` process group, one rank per
device, each rank one process running the same program (SPMD): rank r
owns rows [r·B, (r+1)·B) of the padded axis, the layout of the
reference's `NamedSharding` on a 1-D mesh.

  * the node-parallel stages (local SGD, DGC sparsify, ALDP, the cloud
    evaluation) run on each rank's block with no communication;
  * the small cross-node steps (the detection threshold, the masked
    mean, the async Eq. (6)/`mix_stale` fold and its accuracy ring) see
    values gathered from every rank and run replicated, so their results
    are the same bits on every rank.

The node axis is padded up to a multiple of the rank count
(`FleetMesh.padded`); padding rows carry a size-1 zero shard, never
participate and never arrive (+inf clocks).  NCCL runs on the card and
gloo on the CPU: `FleetMesh.device` refuses a device the group's backend
does not serve.

The collectives the sharded programs are written with: `my_block` (a
replicated tensor cut to this rank's block), `gather_rows` (global rows
out of a node-sharded tensor, replicated on every rank by a masked
`all_reduce`), `scatter_rows` (replicated rows written back into their
owner's block) and `all_gather_tree` (blocks back to the global order).

`MeshStateIO` is the state surface both engines inherit: adopt run-held
residuals and a chain key (`load_state`), hand residuals back
(`export_residuals`), and the full-state snapshot a bit-exact
checkpoint/resume needs (`export_sim_state` / `load_sim_state`).  The
snapshot's names and layouts are the reference's, host numpy arrays over
the real nodes whatever the layout, so a checkpoint the JAX package wrote
loads here and the other way round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import tree as tree_util


def _dist():
    import torch.distributed as dist
    return dist


def is_writer() -> bool:
    """Does this process write a run's files?  Rank 0 of an initialised
    default process group, or a process outside any group."""
    dist = _dist()
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the default group (no-op outside one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class FleetMesh:
    """A 1-D mesh over the fleet's node axis: the ranks of the default
    process group.  Build it with `create`."""

    def __init__(self, n_devices: int, rank: int, backend: str):
        self.n_devices = int(n_devices)
        self.rank = int(rank)
        self.backend = str(backend)

    @classmethod
    def create(cls, n_devices: Optional[int] = None) -> "FleetMesh":
        """The mesh over the initialised default process group
        (``n_devices=None``: its world size).  Raises ValueError when no
        group is initialised or when ``n_devices`` differs from the world
        size: there is no fallback to one device."""
        dist = _dist()
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                "FleetMesh needs an initialised torch.distributed default "
                "process group: call torch.distributed.init_process_group("
                "backend ('nccl' on CUDA, 'gloo' on the CPU), init_method="
                "'tcp://localhost:<port>' or 'file://<path>', world_size=, "
                "rank=) in every rank's process first")
        world = dist.get_world_size()
        if n_devices is None:
            n_devices = world
        if int(n_devices) != world:
            raise ValueError(
                f"FleetMesh over {n_devices} devices requested but the "
                f"process group has {world} ranks; start one process per "
                f"device with world_size={n_devices}")
        return cls(world, dist.get_rank(), dist.get_backend())

    def padded(self, n_nodes: int) -> int:
        """Node count rounded up to a shard multiple."""
        d = self.n_devices
        return ((n_nodes + d - 1) // d) * d

    def device(self, device) -> torch.device:
        """This rank's device for a run asked to go on ``device``: the
        card ``rank % device_count`` under NCCL, the CPU under gloo.
        Raises when the group's backend does not serve that device."""
        dev = torch.device(device)
        if dev.type == "cuda":
            if self.backend != "nccl":
                raise ValueError(f"a CUDA fleet mesh needs the 'nccl' "
                                 f"backend, the group runs "
                                 f"{self.backend!r}")
            return torch.device("cuda", self.rank % torch.cuda.device_count())
        if self.backend != "gloo":
            raise ValueError(f"a {dev.type} fleet mesh needs the 'gloo' "
                             f"backend, the group runs {self.backend!r}")
        return dev

    def bounds(self, n_rows: int):
        """[lo, hi) of this rank's block of an ``n_rows`` axis (a shard
        multiple)."""
        if n_rows % self.n_devices:
            raise ValueError(f"{n_rows} rows do not split over "
                             f"{self.n_devices} ranks")
        b = n_rows // self.n_devices
        return self.rank * b, (self.rank + 1) * b

    # -- placement ----------------------------------------------------------
    def put_nodes(self, tree):
        """Every leaf cut to this rank's block of its leading (node) axis,
        whose length must already be a shard multiple (`padded`)."""
        return tree_util.map(lambda x: my_block(x, self).clone(), tree)

    def put_replicated(self, tree):
        """A replicated tree: every rank keeps the whole of each leaf."""
        return tree


# ---------------------------------------------------------------------------
# collectives used inside the sharded round and window programs
#
# Each takes the mesh and a node-sharded operand whose leading axis is this
# rank's block of B rows; rank r owns global rows [r·B, (r+1)·B).
# ---------------------------------------------------------------------------

def my_block(x: torch.Tensor, mesh: FleetMesh) -> torch.Tensor:
    """This rank's contiguous block of a replicated tensor whose leading
    axis is a multiple of the rank count (replicated -> sharded)."""
    lo, hi = mesh.bounds(x.shape[0])
    return x[lo:hi]


def my_block_tree(tree, mesh: FleetMesh):
    return tree_util.map(lambda x: my_block(x, mesh), tree)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks, in place, as the same bits on every rank."""
    if x.dtype == torch.bool:
        raise TypeError("all_reduce_sum of a bool tensor")
    _dist().all_reduce(x)
    return x


def gather_rows(x_local: torch.Tensor, idx, mesh: FleetMesh
                ) -> torch.Tensor:
    """Global rows ``idx`` (host ints) of a node-sharded tensor, replicated
    on every rank.  Each rank contributes the rows it owns (zeros
    elsewhere) and an `all_reduce` sums them: exactly one rank owns each
    row, so the sum is exact."""
    block = x_local.shape[0]
    local = np.asarray(idx, np.int64) - mesh.rank * block
    mine = (local >= 0) & (local < block)
    dtype = x_local.dtype
    src = x_local.to(torch.uint8) if dtype == torch.bool else x_local
    out = src.new_zeros((local.shape[0],) + tuple(src.shape[1:]))
    if mine.any():
        pos = torch.as_tensor(np.flatnonzero(mine), device=src.device)
        rows = torch.as_tensor(local[mine], device=src.device)
        out.index_copy_(0, pos, src.index_select(0, rows))
    all_reduce_sum(out)
    return out.to(torch.bool) if dtype == torch.bool else out


def gather_rows_tree(tree_local, idx, mesh: FleetMesh):
    return tree_util.map(lambda x: gather_rows(x, idx, mesh), tree_local)


def scatter_rows(x_local: torch.Tensor, idx, values: torch.Tensor, keep,
                 mesh: FleetMesh) -> torch.Tensor:
    """Write replicated rows ``values`` (one per entry of ``idx``) into
    the node-sharded tensor, in place: each rank writes only the rows it
    owns; ``keep`` (host bools) masks entries that must not be written.
    Duplicated indices must carry identical rows (last write wins, as
    `state.scatter_nodes`)."""
    block = x_local.shape[0]
    local = np.asarray(idx, np.int64) - mesh.rank * block
    mine = np.asarray(keep, bool) & (local >= 0) & (local < block)
    if mine.any():
        pos = torch.as_tensor(np.flatnonzero(mine), device=x_local.device)
        rows = torch.as_tensor(local[mine], device=x_local.device)
        x_local.index_copy_(0, rows, values.index_select(0, pos)
                            .to(x_local.dtype))
    return x_local


def scatter_rows_tree(tree_local, idx, values, keep, mesh: FleetMesh):
    return tree_util.map(
        lambda x, v: scatter_rows(x, idx, v, keep, mesh), tree_local, values)


def all_gather(x_local: torch.Tensor, mesh: FleetMesh) -> torch.Tensor:
    """Every rank's block concatenated in global row order (sharded ->
    replicated)."""
    dist = _dist()
    dtype = x_local.dtype
    src = (x_local.to(torch.uint8) if dtype == torch.bool
           else x_local).contiguous()
    out = src.new_empty((src.shape[0] * mesh.n_devices,)
                        + tuple(src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src)
    return out.to(torch.bool) if dtype == torch.bool else out


def all_gather_tree(tree, mesh: FleetMesh):
    return tree_util.map(lambda x: all_gather(x, mesh), tree)


# ---------------------------------------------------------------------------
# the engines' state surface
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class MeshStateIO:
    """State surface shared by both fleet engines.

    Host classes provide ``self.device``, ``self.mesh`` (a `FleetMesh` or
    None), ``self.n_nodes``, ``self.n_pad``, ``self.params`` and
    ``self.state`` (a `FleetState`, its node rows this rank's block on a
    mesh).
    """

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """A node-sharded tensor gathered whole (n_pad rows)."""
        return x if self.mesh is None else all_gather(x, self.mesh)

    def load_state(self, residuals_stacked, chain_key) -> None:
        """Adopt externally held stacked residuals (n_nodes rows, copied
        onto the engine's device; padded and cut to this rank's block on
        a mesh) and a chain key."""
        res = tree_util.map(
            lambda x: x.to(self.device, torch.float32).clone(),
            residuals_stacked)
        if self.mesh is not None:
            from .state import pad_node_axis
            res = self.mesh.put_nodes(pad_node_axis(res, self.n_pad))
        self.state.residuals = res
        self.state.chain_key = np.asarray(chain_key, np.uint32)

    def export_residuals(self):
        """The stacked residuals over the real nodes (leaves (n_nodes, ...)
        on the device; gathered from every rank on a mesh)."""
        if self.mesh is None:
            return self.state.residuals
        return tree_util.map(lambda x: self._whole(x)[:self.n_nodes],
                             self.state.residuals)

    def _participation_mask(self, idx, valid) -> np.ndarray:
        """(idx, valid) cohort -> per-node bool mask over the padded fleet
        (padding rows always False)."""
        up = np.zeros(self.n_pad, bool)
        up[np.asarray(idx)[np.asarray(valid, bool)]] = True
        return up

    # -- full-state snapshot (sim.SimService checkpoint/resume) -------------
    # per-node FleetState fields (leading node axis, trimmed to the real
    # nodes) and replicated fields; None fields are absent from the
    # snapshot, so sync/async engines and defense on/off variants share
    # this one code path
    _SIM_NODE_FIELDS = ("next_arrival", "dispatched_version", "trust",
                        "throttle")
    _SIM_REP_FIELDS = ("version", "acc_ring", "acc_count")

    def export_sim_state(self) -> dict:
        """Every array a bit-exact resume needs, as a flat dict of host
        numpy arrays and trees in the reference's dtypes (``version`` and
        ``acc_count`` 0-d int32, ``acc_ring`` float32 with NaN for empty
        slots, the chain key uint32 (2,)), padding rows dropped.  On a
        mesh every rank must call it (it gathers)."""
        st = self.state
        n = self.n_nodes

        def trim(x):
            return _host(self._whole(x)[:n])

        out = {
            "params": tree_util.map(_host, self.params),
            "chain_key": _key_data(st.chain_key),
            "residuals": tree_util.map(trim, st.residuals),
        }
        if st.dispatched is not None:
            out["dispatched"] = tree_util.map(trim, st.dispatched)
        for name in self._SIM_NODE_FIELDS:
            v = getattr(st, name)
            if v is not None:
                out[name] = trim(v)
        if st.version is not None:
            out["version"] = np.asarray(st.version, np.int32)
        if st.acc_ring is not None:
            out["acc_ring"] = _host(st.acc_ring).astype(np.float32)
        if st.acc_count is not None:
            out["acc_count"] = np.asarray(st.acc_count, np.int32)
        return out

    def load_sim_state(self, tree: dict) -> None:
        """Restore an `export_sim_state` snapshot (this package's or the
        reference's) into this engine.

        The engine must be freshly constructed for the same spec shape.
        Real-node rows are overwritten; padding rows keep their init
        values (+inf clocks, dummy data), which never participate.  Every
        array keeps the engine's own dtype and device.  Fields present in
        the snapshot but absent on this engine (or the other way round,
        e.g. trust rows after a defense-onset event) keep their fresh
        init — what a mid-run spec mutation wants.  On a mesh every rank
        must call it (it gathers).
        """
        st = self.state
        n = self.n_nodes

        def rows(cur: torch.Tensor, new) -> torch.Tensor:
            new = torch.as_tensor(np.asarray(new))
            whole = self._whole(cur)
            if (tuple(new.shape[1:]) != tuple(whole.shape[1:])
                    or new.shape[0] != n):
                raise ValueError(f"load_sim_state: snapshot rows "
                                 f"{tuple(new.shape)} != engine "
                                 f"({n},) + {tuple(whole.shape[1:])}")
            whole = whole.clone()
            whole[:n] = new.to(whole.device, whole.dtype)
            return (whole if self.mesh is None
                    else self.mesh.put_nodes(whole))

        updates = {
            "residuals": tree_util.map(rows, st.residuals,
                                       tree["residuals"]),
            "chain_key": _key_like(st.chain_key, tree["chain_key"]),
        }
        if st.dispatched is not None and "dispatched" in tree:
            updates["dispatched"] = tree_util.map(rows, st.dispatched,
                                                  tree["dispatched"])
        for name in self._SIM_NODE_FIELDS:
            cur = getattr(st, name)
            if cur is not None and name in tree:
                updates[name] = rows(cur, tree[name])
        if st.version is not None and "version" in tree:
            updates["version"] = int(np.asarray(tree["version"]))
        if st.acc_ring is not None and "acc_ring" in tree:
            updates["acc_ring"] = torch.as_tensor(
                np.asarray(tree["acc_ring"], np.float32)).to(
                    st.acc_ring.device)
        if st.acc_count is not None and "acc_count" in tree:
            updates["acc_count"] = int(np.asarray(tree["acc_count"]))
        self.state = dataclasses.replace(st, **updates)
        self.params = tree_util.map(
            lambda cur, new: torch.as_tensor(np.asarray(new)).to(
                cur.device, cur.dtype), self.params, tree["params"])


def _key_data(key) -> np.ndarray:
    """The chain key as raw host bits (the port keeps raw uint32 (2,)
    keys, as the reference does without typed keys)."""
    return np.array(key, np.uint32)


def _key_like(cur, data) -> np.ndarray:
    """Raw key bits back to the kind of key the engine carries."""
    return np.array(data, np.uint32).reshape(np.shape(cur))
