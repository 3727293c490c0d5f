"""Declarative fleet scenarios: named node populations over the api spec.

Port of `repro.fleet.scenarios`.  A `Scenario` describes a whole
population (size, adversary fraction, stragglers, churn, sampling,
privacy and compression knobs) and `to_spec()` emits the
`api.ExperimentSpec` it denotes, the same JSON as the reference's.  The
builders run ``compile_plan`` -> ``materialize`` -> ``make_engine`` on
``device`` (CUDA unless the caller passes "cpu"); a ``mesh`` builder
argument (a `mesh.FleetMesh`) shards the node axis over its ranks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .async_engine import AsyncFleetEngine
from .engine import ClientSampler, FleetEngine


@dataclass(frozen=True)
class Scenario:
    """One node population + training regime, fully declarative."""
    name: str
    n_nodes: int = 10
    # population composition
    malicious_frac: float = 0.0         # adversary fraction (see attack_kind)
    attack_kind: str = "label_flip"     # api.AttackMix zoo kind
    placement: str = "random"           # malicious-node placement
    straggler_frac: float = 0.0         # nodes with `straggler_slowdown`x compute
    straggler_slowdown: float = 10.0
    availability: float = 1.0           # per-round P(node is reachable)
    cohort_frac: float = 1.0            # uniform-C sampling fraction (<1)
    heterogeneity: float = 0.5          # lognormal sigma of compute speeds
    base_compute_s: float = 1.0
    bandwidth_bps: float = 12.5e6
    # training / privacy / communication
    model: str = "mlp"                  # mlp | cnn
    hw: Tuple[int, int] = (8, 8)
    local_steps: int = 5
    batch_size: int = 16
    lr: float = 0.1
    alpha: float = 0.5
    sigma: float = 0.0
    clip_s: float = 1.0
    detect: bool = False
    detect_s: float = 80.0
    defense_kind: str = "percentile"    # percentile | trust_weighted
    sparsify_ratio: float = 1.0
    # async scheduling (consumed by build_async_engine only)
    staleness_adaptive: bool = False
    async_window: Optional[float] = None  # None => parity-safe auto window
    async_mixing: str = "sequential"      # sequential | buffered
    # data sizing
    samples_per_node: int = 60
    n_test: int = 256
    n_cloud_test: int = 128

    def with_nodes(self, n_nodes: int) -> "Scenario":
        return dataclasses.replace(self, n_nodes=n_nodes)

    def to_spec(self, kind: Optional[str] = None, rounds: int = 10,
                seed: int = 0, backend: str = "reference",
                mesh_devices: Optional[int] = None):
        """Emit the `api.ExperimentSpec` this scenario denotes.

        ``kind`` is the schedule ("sync" | "async" | "buffered"); None
        picks "sync", or the scenario's own async mixing when it declares
        async knobs.  ``mesh_devices`` selects a mesh topology.
        """
        from ..api import spec as s
        from ..api.window import AutoWindow, FixedWindow

        if kind is None:
            declares_async = (self.async_mixing != "sequential"
                              or self.async_window is not None
                              or self.staleness_adaptive)
            kind = self.async_kind() if declares_async else "sync"
        window = (FixedWindow(self.async_window)
                  if kind != "sync" and self.async_window is not None
                  else AutoWindow())
        topology = (s.Topology(kind="mesh", devices=mesh_devices,
                               backend=backend)
                    if mesh_devices is not None
                    else s.Topology(kind="single", backend=backend))
        return s.ExperimentSpec(
            fleet=s.FleetSpec(
                n_nodes=self.n_nodes,
                profile=s.NodeHeterogeneity(
                    base_compute_s=self.base_compute_s,
                    heterogeneity=self.heterogeneity,
                    bandwidth_bps=self.bandwidth_bps,
                    straggler_frac=self.straggler_frac,
                    straggler_slowdown=self.straggler_slowdown),
                attack=s.AttackMix(malicious_frac=self.malicious_frac,
                                   kind=self.attack_kind,
                                   placement=self.placement),
                availability=self.availability,
                cohort_frac=self.cohort_frac,
                model=self.model, hw=self.hw,
                samples_per_node=self.samples_per_node,
                n_test=self.n_test, n_cloud_test=self.n_cloud_test),
            schedule=s.SchedulePolicy(
                kind=kind, alpha=self.alpha,
                staleness_adaptive=(self.staleness_adaptive
                                    if kind != "sync" else False),
                window=window),
            privacy=s.PrivacySpec(sigma=self.sigma, clip_s=self.clip_s),
            compression=s.CompressionSpec(
                sparsify_ratio=self.sparsify_ratio),
            defense=s.DefenseSpec(detect=self.detect,
                                  detect_s=self.detect_s,
                                  kind=self.defense_kind),
            topology=topology,
            train=s.TrainSpec(local_steps=self.local_steps,
                              batch_size=self.batch_size, lr=self.lr),
            rounds=rounds, seed=seed)

    def async_kind(self) -> str:
        """The async schedule kind this scenario declares."""
        return "buffered" if self.async_mixing == "buffered" else "async"


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario("honest"),
    Scenario("label_flip_20", malicious_frac=0.2, detect=True),
    Scenario("stragglers", straggler_frac=0.2, straggler_slowdown=20.0),
    Scenario("churn", availability=0.7),
    Scenario("sampled_cohort", n_nodes=50, cohort_frac=0.2),
    Scenario("private_sparse", sigma=0.05, sparsify_ratio=0.1, detect=True),
    # adversary-zoo populations (api.AttackMix kinds + trust defense)
    Scenario("sybil_trust", malicious_frac=0.2, attack_kind="sybil",
             detect=True, defense_kind="trust_weighted"),
    Scenario("backdoor_20", malicious_frac=0.2, attack_kind="backdoor",
             detect=True),
    # asynchronous populations (run via build_async_engine)
    Scenario("async_stragglers", straggler_frac=0.2, straggler_slowdown=20.0,
             staleness_adaptive=True),
    Scenario("async_churn", availability=0.7),
    Scenario("async_label_flip", malicious_frac=0.2, detect=True),
    Scenario("async_adaptive_trust", malicious_frac=0.2,
             attack_kind="adaptive", detect=True,
             defense_kind="trust_weighted", staleness_adaptive=True),
    Scenario("async_buffered", async_mixing="buffered", async_window=2.0),
]}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have "
                       f"{sorted(SCENARIOS)}") from None


def _build(sc: Scenario, kind: str, seed: int, sampler, backend, mesh,
           device):
    """Scenario -> spec -> plan -> engine, with a sampler override."""
    from .. import api

    spec = sc.to_spec(kind=kind, seed=seed, backend=backend)
    plan = api.compile_plan(spec)
    pop = api.materialize(spec, device=device)
    if sampler is not None:
        pop = dataclasses.replace(pop, sampler=sampler)
    return api.make_engine(plan, pop, device=device, mesh=mesh)


def build_engine(sc: Scenario, seed: int = 0,
                 sampler: Optional[ClientSampler] = None,
                 backend: str = "reference", mesh=None,
                 device=None) -> FleetEngine:
    """Scenario -> FleetEngine on synthetic federated image data;
    ``mesh`` (a `FleetMesh`) shards the node axis over its ranks."""
    return _build(sc, "sync", seed, sampler, backend, mesh, device)


def build_async_engine(sc: Scenario, seed: int = 0,
                       sampler: Optional[ClientSampler] = None,
                       backend: str = "reference", mesh=None,
                       device=None) -> AsyncFleetEngine:
    """Scenario -> AsyncFleetEngine (virtual-time arrival windows):
    ``availability < 1`` loses arrivals in transit, ``cohort_frac < 1``
    gates arrivals per window to a sampled cohort."""
    return _build(sc, sc.async_kind(), seed, sampler, backend, mesh, device)
