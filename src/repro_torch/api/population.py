"""Materialize a `FleetSpec` into an executable population.

Port of `repro.api.population`.  The data, the malicious placement and
the node profile are numpy and bit-identical to the reference's for the
same seed.  The model init draws from a `torch.Generator` seeded with the
spec seed, so its weights differ from the reference's `jax.random` init;
to run both packages from the same weights, build a `Population` with the
reference's params carried over (`convert.to_torch`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import make_federated_image_data
from ..device import resolve
from ..fleet.engine import (AvailabilityTrace, ClientSampler, NodeProfile,
                            UniformSampler)
from ..models.cnn import cnn_accuracy, cnn_loss, init_cnn
from ..models.mlp import init_mlp, mlp_accuracy, mlp_loss
from .spec import ExperimentSpec


@dataclass
class Population:
    """A concrete fleet: params (dict of tensors), callables, numpy data
    shards, system profile."""
    params: Any
    loss_fn: Callable
    acc_fn: Callable
    node_data: Sequence[Tuple[np.ndarray, np.ndarray]]
    test_data: Tuple[np.ndarray, np.ndarray]
    cloud_test: Tuple[np.ndarray, np.ndarray]
    profile: NodeProfile
    sampler: Optional[ClientSampler] = None
    malicious_ids: Tuple[int, ...] = ()

    @property
    def n_nodes(self) -> int:
        return len(self.node_data)


def default_sampler(spec: ExperimentSpec) -> Optional[ClientSampler]:
    """The participation model the spec declares (or None: everyone)."""
    f = spec.fleet
    if f.availability < 1.0:
        return AvailabilityTrace(probs=np.full(f.n_nodes, f.availability),
                                 seed=spec.seed)
    if f.cohort_frac < 1.0:
        return UniformSampler(max(1, int(round(f.cohort_frac * f.n_nodes))),
                              seed=spec.seed)
    return None


def model_fns(model: str) -> Tuple[Callable, Callable]:
    """(loss_fn, acc_fn) of a `FleetSpec.model` name."""
    if model == "cnn":
        return cnn_loss, cnn_accuracy
    return mlp_loss, mlp_accuracy


def materialize(spec: ExperimentSpec, device=None) -> Population:
    """`FleetSpec` -> `Population` on synthetic federated image data, with
    the params on ``device`` (CUDA by default).  Deterministic in
    ``spec.seed``."""
    dev = resolve(device)
    f = spec.fleet
    atk = f.attack
    n_malicious = int(round(atk.malicious_frac * f.n_nodes))
    node_data, test, cloud, malicious = make_federated_image_data(
        spec.seed, n_nodes=f.n_nodes, n_malicious=n_malicious,
        n_train=f.samples_per_node * f.n_nodes, n_test=f.n_test,
        n_cloud_test=f.n_cloud_test, hw=f.hw, n_classes=f.n_classes,
        flip_src=atk.flip_src, flip_dst=atk.flip_dst,
        iid=f.iid, dirichlet_alpha=f.dirichlet_alpha,
        attack_kind=atk.kind, placement=atk.placement,
        trigger_frac=atk.trigger_frac, trigger_label=atk.trigger_label,
        trigger_size=atk.trigger_size, trigger_value=atk.trigger_value)

    gen = torch.Generator().manual_seed(int(spec.seed))
    if f.model == "cnn":
        params = init_cnn(gen, in_hw=f.hw, device=dev)
    else:
        params = init_mlp(gen, in_dim=f.hw[0] * f.hw[1], device=dev)
    loss_fn, acc_fn = model_fns(f.model)

    p = f.profile
    profile = NodeProfile.lognormal(
        f.n_nodes, p.base_compute_s, p.heterogeneity, p.bandwidth_bps,
        seed=spec.seed, straggler_frac=p.straggler_frac,
        straggler_slowdown=p.straggler_slowdown)
    return Population(params=params, loss_fn=loss_fn, acc_fn=acc_fn,
                      node_data=node_data, test_data=test, cloud_test=cloud,
                      profile=profile, sampler=default_sampler(spec),
                      malicious_ids=tuple(int(m) for m in malicious))
