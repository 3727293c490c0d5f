"""Engine state ingress/egress: `MeshStateIO` for one device.

Port of `repro.fleet.mesh.MeshStateIO`, the state surface both fleet
engines inherit: adopt run-held residuals and a chain key
(`load_state`), hand residuals back (`export_residuals`), and the
full-state snapshot a bit-exact checkpoint/resume needs
(`export_sim_state` / `load_sim_state`).  The snapshot's names and
layouts are the reference's — ``params``, ``chain_key``, ``residuals``,
``dispatched``, ``next_arrival``, ``dispatched_version``, ``trust``,
``throttle``, ``version``, ``acc_ring``, ``acc_count`` — as host numpy
arrays over the real nodes, so a checkpoint the JAX package wrote loads
here and the other way round.

`FleetMesh` and the node-sharded round and window programs are not
ported: they wait for ROADMAP.md item 15 ('Multi-device:
torch.distributed').  On one device the node axis has no padding rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tree as tree_util


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class MeshStateIO:
    """State surface shared by both fleet engines.

    Host classes provide ``self.device``, ``self.n_nodes``, ``self.params``
    and ``self.state`` (a `FleetState`).
    """

    def load_state(self, residuals_stacked, chain_key) -> None:
        """Adopt externally held stacked residuals (n_nodes rows, copied
        onto the engine's device) and a chain key."""
        self.state.residuals = tree_util.map(
            lambda x: x.to(self.device, torch.float32).clone(),
            residuals_stacked)
        self.state.chain_key = np.asarray(chain_key, np.uint32)

    def export_residuals(self):
        """The stacked residuals (leaves (n_nodes, ...) on the device)."""
        return self.state.residuals

    # -- full-state snapshot (sim.SimService checkpoint/resume) -------------
    # per-node FleetState fields (leading node axis) and replicated fields;
    # None fields are absent from the snapshot, so sync/async engines and
    # defense on/off variants share this one code path
    _SIM_NODE_FIELDS = ("next_arrival", "dispatched_version", "trust",
                        "throttle")
    _SIM_REP_FIELDS = ("version", "acc_ring", "acc_count")

    def export_sim_state(self) -> dict:
        """Every array a bit-exact resume needs, as a flat dict of host
        numpy arrays and trees in the reference's dtypes (``version`` and
        ``acc_count`` 0-d int32, ``acc_ring`` float32 with NaN for empty
        slots, the chain key uint32 (2,))."""
        st = self.state
        out = {
            "params": tree_util.map(_host, self.params),
            "chain_key": _key_data(st.chain_key),
            "residuals": tree_util.map(_host, st.residuals),
        }
        if st.dispatched is not None:
            out["dispatched"] = tree_util.map(_host, st.dispatched)
        for name in self._SIM_NODE_FIELDS:
            v = getattr(st, name)
            if v is not None:
                out[name] = _host(v)
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
        Every array keeps the engine's own dtype and device.  Fields
        present in the snapshot but absent on this engine (or the other
        way round, e.g. trust rows after a defense-onset event) keep
        their fresh init — what a mid-run spec mutation wants.
        """
        st = self.state
        n = self.n_nodes

        def rows(cur: torch.Tensor, new) -> torch.Tensor:
            new = torch.as_tensor(np.asarray(new))
            if tuple(new.shape) != tuple(cur.shape) or new.shape[0] != n:
                raise ValueError(f"load_sim_state: snapshot rows "
                                 f"{tuple(new.shape)} != engine "
                                 f"{tuple(cur.shape)}")
            return new.to(cur.device, cur.dtype)

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
