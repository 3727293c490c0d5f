"""Stacked fleet state: every per-node quantity on a leading node axis.

Port of `repro.fleet.state`.  Device tensors hold what the round program
reads and writes (residuals, dispatched models, virtual clocks, versions);
the PRNG chain key and the async detection ring are host-side scalars,
advanced by the host bookkeeping in `prng` and the async control scan.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tree as tree_util
from ..prng import (chain_node_keys, chain_node_keys_masked,  # noqa: F401
                    parallel_node_keys)


def broadcast_tree(tree, n: int):
    """Tile a tree along a new leading node axis of size ``n`` (a view)."""
    return tree_util.map(lambda x: x[None].expand((n,) + tuple(x.shape)),
                         tree)


def gather_nodes(tree, idx: torch.Tensor):
    """Rows ``idx`` of every leaf's node axis (fleet -> cohort)."""
    return tree_util.map(lambda x: x.index_select(0, idx), tree)


@dataclass
class FleetState:
    """Per-node training state.

    residuals: DGC accumulation containers (§5.1), leaves (N, ...) on the
      device, updated in place round by round.
    chain_key: the engine's PRNG chain key, uint32 (2,) on the host.
    round: round counter.
    The asynchronous engine adds: dispatched (the stacked params each node
    trains from), next_arrival ((N,) f32 virtual clocks), dispatched_version
    ((N,) int32), version (global model version), acc_ring ((W,) f32 on the
    host, NaN = empty) and acc_count (total pushes).
    The trust-scored defense and the adaptive attacker add (N,) f32 device
    rows, None unless the spec needs them: trust (per-node trust in
    [0, 1], `detection.trust_update`) and throttle (the detection-aware
    attacker's per-node poison scale, `stages.adaptive_throttle_update`).
    """
    residuals: object
    chain_key: np.ndarray
    round: int = 0
    dispatched: object = None
    next_arrival: Optional[torch.Tensor] = None
    dispatched_version: Optional[torch.Tensor] = None
    version: Optional[int] = None
    acc_ring: Optional[torch.Tensor] = None
    acc_count: Optional[int] = None
    trust: Optional[torch.Tensor] = None
    throttle: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return tree_util.leaves(self.residuals)[0].shape[0]


def init_fleet_state(template_params, n_nodes: int, key, *,
                     trust: bool = False,
                     throttle: bool = False) -> FleetState:
    """Zero residuals for every node + the engine's starting chain key;
    ``trust``/``throttle`` allocate the optional (N,) rows at 1.0."""
    residuals = tree_util.map(
        lambda x: torch.zeros((n_nodes,) + tuple(x.shape),
                              dtype=torch.float32, device=x.device),
        template_params)
    dev = tree_util.leaves(template_params)[0].device
    ones = lambda on: (torch.ones(n_nodes, dtype=torch.float32,  # noqa: E731
                                  device=dev) if on else None)
    return FleetState(residuals=residuals,
                      chain_key=np.asarray(key, np.uint32),
                      trust=ones(trust), throttle=ones(throttle))


def init_async_fleet_state(template_params, n_nodes: int, key,
                           first_arrival: np.ndarray,
                           detect_window: int, *, trust: bool = False,
                           throttle: bool = False) -> FleetState:
    """Every node starts with the global model (version 0) in flight,
    arriving when its first local compute finishes; empty ring."""
    st = init_fleet_state(template_params, n_nodes, key, trust=trust,
                          throttle=throttle)
    dev = tree_util.leaves(template_params)[0].device
    return dataclasses.replace(
        st,
        dispatched=tree_util.map(lambda x: x[None].repeat(
            (n_nodes,) + (1,) * x.ndim), template_params),
        next_arrival=torch.as_tensor(np.asarray(first_arrival, np.float32),
                                     device=dev),
        dispatched_version=torch.zeros(n_nodes, dtype=torch.int32,
                                       device=dev),
        version=0,
        acc_ring=torch.full((detect_window,), float("nan"),
                            dtype=torch.float32),
        acc_count=0)


@dataclass
class FleetData:
    """Per-node data shards stacked to (N, M, ...) with right-padding on
    the device; ``sizes`` (each node's true shard length) stays on the host,
    where the minibatch indices are drawn."""
    x: torch.Tensor
    y: torch.Tensor
    sizes: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.x.shape[0])

    @classmethod
    def from_node_data(cls, node_data: Sequence[Tuple[np.ndarray,
                                                      np.ndarray]],
                       device="cpu") -> "FleetData":
        if len(node_data) == 0:
            raise ValueError("FleetData.from_node_data: empty node list — "
                             "a fleet needs at least one node shard")
        sizes = np.array([len(y) for _, y in node_data], np.int32)
        if (sizes == 0).any():
            empty = np.nonzero(sizes == 0)[0].tolist()
            raise ValueError(
                f"FleetData.from_node_data: node(s) {empty} have empty data "
                f"shards; every node needs at least one sample")
        m = int(sizes.max())
        x0, y0 = (np.asarray(a) for a in node_data[0])
        xs = np.zeros((len(node_data), m) + x0.shape[1:], x0.dtype)
        ys = np.zeros((len(node_data), m), y0.dtype)
        for i, (x, y) in enumerate(node_data):
            xs[i, :len(y)] = x
            ys[i, :len(y)] = y
        return cls(x=torch.as_tensor(xs, device=device),
                   y=torch.as_tensor(ys, device=device), sizes=sizes)

    def pad_to(self, n_total: int) -> "FleetData":
        """Append dummy nodes up to ``n_total`` rows (mesh shard
        multiples): one zero sample each (``sizes`` 1, so minibatch draws
        in [0, size) stay defined).  Sharded engines mask them out of
        every aggregate, so their updates never land anywhere."""
        pad = n_total - self.n_nodes
        if pad < 0:
            raise ValueError(f"pad_to: fleet already has {self.n_nodes} "
                             f"nodes > requested {n_total}")
        if pad == 0:
            return self
        return FleetData(
            x=torch.cat([self.x, self.x.new_zeros((pad,)
                                                  + tuple(self.x.shape[1:]))]),
            y=torch.cat([self.y, self.y.new_zeros((pad,)
                                                  + tuple(self.y.shape[1:]))]),
            sizes=np.concatenate([self.sizes,
                                  np.ones(pad, self.sizes.dtype)]))


def pad_node_axis(tree, n_total: int):
    """Zero-pad every leaf's leading node axis up to ``n_total`` rows (the
    stacked-tree analogue of `FleetData.pad_to`)."""
    def one(x):
        pad = n_total - x.shape[0]
        if pad < 0:
            raise ValueError(f"pad_node_axis: leading axis {x.shape[0]} "
                             f"> requested {n_total}")
        if pad == 0:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return tree_util.map(one, tree)


def pad_keys(keys: np.ndarray, n_total: int) -> np.ndarray:
    """Pad stacked per-node keys ((n, 2) uint32) to ``n_total`` rows by
    repeating the last real key: padding rows only feed masked-out dummy
    updates, but their keys must still be valid."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    return keys[np.minimum(np.arange(n_total), n - 1)]
