"""Execute an `ExperimentPlan`: plan -> engine -> `RunReport`.

Port of the fleet-engine half of `repro.api.run`: `make_engine`, the sync
and async record steppers, `init_state`, `make_stepper`, `execute` and
`run`.  One record per barrier round (sync) or per n_nodes arrivals
(async), exactly as the reference emits them.  A spec whose
`NetworkSpec` names a codec attaches a `net.NetSim` to the engine: the
records then carry encoded bytes (``bytes_source="encoded"``) and
`RunReport.net` the trace summary.  Everything runs on ``device``
("cuda" unless the caller passes "cpu").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from .. import fleet, prng
from .. import tree as tree_util
from ..core import async_update
from ..core.accountant import MomentsAccountant
from ..device import resolve
from ..fleet import stages as fleet_stages
from ..net import netsim_from_network
from .plan import ExperimentPlan, SpecError
from .population import Population, materialize
from .report import RoundRecord, RunReport, detection_log


@dataclass
class RunState:
    """What evolves over a run and survives it: the global model, the
    host-side PRNG chain key, the stacked per-node DGC residuals (leaves
    (N, ...) on the device), the privacy accountant and the records."""
    params: Any
    key: np.ndarray
    residuals: Any
    accountant: Optional[MomentsAccountant]
    history: List[RoundRecord] = field(default_factory=list)
    net: Optional[dict] = None      # NetTrace summary when a codec ran


def init_state(plan: ExperimentPlan, population: Population,
               device=None) -> RunState:
    """Fresh run state: ω_0 from the population, chain key from the spec
    seed, zero residuals, an accountant only when σ > 0."""
    dev = resolve(device)
    params = tree_util.map(lambda x: x.to(dev), population.params)
    n = population.n_nodes
    return RunState(
        params=params, key=prng.PRNGKey(plan.spec.seed),
        residuals=tree_util.map(
            lambda x: torch.zeros((n,) + tuple(x.shape), dtype=torch.float32,
                                  device=dev), params),
        accountant=(MomentsAccountant(plan.sigma, 1.0)
                    if plan.sigma > 0 else None))


def make_engine(plan: ExperimentPlan, population: Population, device=None):
    """Build the fleet engine a plan selects (sequential PRNG chain,
    reference/pallas backend, the population's profile/sampler, the
    network transport when the spec names a codec)."""
    spec = plan.spec
    common = dict(
        local_steps=spec.train.local_steps, batch_size=spec.train.batch_size,
        lr=spec.train.lr, alpha=spec.schedule.alpha,
        clip_s=spec.privacy.clip_s, sigma=plan.sigma,
        detect=spec.defense.detect, detect_s=spec.defense.detect_s,
        defense_kind=spec.defense.kind, trust_eta=spec.defense.trust_eta,
        trust_floor=spec.defense.trust_floor,
        uncertainty_scale=spec.defense.uncertainty_scale,
        sparsify_ratio=spec.compression.sparsify_ratio,
        key_mode=plan.key_mode, backend=spec.topology.backend,
        seed=spec.seed)
    args = (population.params, population.loss_fn, population.acc_fn,
            population.node_data, population.test_data, population.cloud_test)
    # the delta-level adversary stages ride the engines only when the
    # spec staffs the fleet with malicious nodes
    attack = (fleet_stages.AttackPlan.from_spec(
                  spec.fleet.attack, population.n_nodes,
                  population.malicious_ids)
              if population.malicious_ids else None)
    n_params = tree_util.size(population.params)
    net = netsim_from_network(
        spec.network, population.profile.bandwidth_bps, n_params,
        sparsify_ratio=spec.compression.sparsify_ratio, seed=spec.seed)
    if plan.mode == "sync":
        return fleet.FleetEngine(
            *args, fleet.FleetConfig(**common), profile=population.profile,
            sampler=population.sampler or fleet.FullParticipation(),
            net=net, device=device, attack=attack)
    bpn = fleet_stages.bytes_per_node(n_params,
                                      spec.compression.sparsify_ratio)
    cfg = fleet.AsyncFleetConfig(
        **common,
        window=spec.schedule.window.resolve(population.profile, bpn),
        mixing="buffered" if plan.mixing == "buffered" else "sequential",
        staleness_adaptive=spec.schedule.staleness_adaptive,
        staleness_a=spec.schedule.staleness_a,
        detect_warmup=spec.defense.detect_warmup,
        detect_window=plan.detect_window)
    return fleet.AsyncFleetEngine(*args, cfg, profile=population.profile,
                                  sampler=population.sampler, net=net,
                                  device=device, attack=attack)


class _SyncFleetStepper:
    """Barrier rounds on the cohort-batched `FleetEngine`."""

    def __init__(self, plan, pop, state, eng):
        self.plan, self.pop, self.state, self.eng = plan, pop, state, eng
        self.src = "encoded" if eng.net is not None else "analytic"
        eng.load_state(state.residuals, state.key)
        self.emitted = 0

    @property
    def done(self) -> bool:
        return self.emitted >= self.plan.spec.rounds

    def step(self) -> None:
        state, eng = self.state, self.eng
        rec = eng.run_round()
        if state.accountant is not None:
            state.accountant.step(rec.n_participating)
        state.params = eng.params
        state.history.append(RoundRecord(
            rec.t, self.emitted, rec.accuracy, rec.comm_bytes, rec.comp_time,
            rec.comm_time, rec.n_rejected, bytes_source=self.src))
        self.emitted += 1

    def finalize(self) -> None:
        _fleet_handback(self.state, self.eng)


class _AsyncFleetStepper:
    """Event-loop cadence on the window-batched `AsyncFleetEngine`: one
    record per n_nodes arrivals; windows are capped so they never
    straddle a record boundary."""

    def __init__(self, plan, pop, state, eng):
        self.plan, self.pop, self.state, self.eng = plan, pop, state, eng
        self.n = pop.n_nodes
        self.src = "encoded" if eng.net is not None else "analytic"
        eng.load_state(state.residuals, state.key)
        self.emitted = 0
        self.processed = 0

    @property
    def done(self) -> bool:
        return self.processed >= self.plan.total_arrivals

    def step(self) -> None:
        state, eng = self.state, self.eng
        target = min(self.processed + self.n, self.plan.total_arrivals)
        span_bytes = span_comp = span_comm = 0.0
        span_rejected = 0
        rec = None
        while self.processed < target:
            rec = eng.run_window(max_arrivals=target - self.processed,
                                 evaluate=False)
            self.processed += rec.n_processed
            if state.accountant is not None:
                state.accountant.step(rec.n_processed)
            state.params = eng.params
            span_bytes += rec.comm_bytes
            span_comp += rec.comp_time
            span_comm += rec.comm_time
            span_rejected += rec.n_rejected
        state.history.append(RoundRecord(
            rec.t, rec.version, eng.global_accuracy(), span_bytes, span_comp,
            span_comm, span_rejected, bytes_source=self.src))
        self.emitted += 1

    def finalize(self) -> None:
        _fleet_handback(self.state, self.eng)


class _BufferedFleetStepper(_AsyncFleetStepper):
    """Buffered (FedBuff) windows: the arrival budget window by window,
    one record per window, with no record boundary inside the event
    loop's cadence."""

    def step(self) -> None:
        state, eng = self.state, self.eng
        rec = eng.run_window(
            max_arrivals=self.plan.total_arrivals - self.processed,
            evaluate=False)
        self.processed += rec.n_processed
        if state.accountant is not None:
            state.accountant.step(rec.n_processed)
        state.params = eng.params
        state.history.append(RoundRecord(
            rec.t, rec.version, eng.global_accuracy(), rec.comm_bytes,
            rec.comp_time, rec.comm_time, rec.n_rejected,
            bytes_source=self.src))
        self.emitted += 1


def _fleet_handback(state: RunState, eng) -> None:
    """Hand node-local state back so follow-on runs stay faithful."""
    state.key = eng.state.chain_key
    state.residuals = eng.export_residuals()
    if eng.net is not None:
        state.net = eng.net.summary()


def make_stepper(plan: ExperimentPlan, population: Population,
                 state: RunState, device=None):
    """Build the record stepper a plan selects."""
    if population.n_nodes != plan.spec.fleet.n_nodes:
        raise SpecError(
            f"population has {population.n_nodes} nodes but the plan was "
            f"compiled for fleet.n_nodes={plan.spec.fleet.n_nodes} — the "
            f"arrival budget and record cadence derive from the spec, so "
            f"a mismatched population would run the wrong experiment")
    eng = make_engine(plan, population, device=device)
    if plan.mode == "sync":
        return _SyncFleetStepper(plan, population, state, eng)
    if plan.mixing == "buffered":
        return _BufferedFleetStepper(plan, population, state, eng)
    return _AsyncFleetStepper(plan, population, state, eng)


def execute(plan: ExperimentPlan, population: Population, state: RunState,
            device=None) -> List[RoundRecord]:
    """Run ``plan`` over ``population``, appending records to
    ``state.history`` and advancing params/key/residuals/accountant."""
    stepper = make_stepper(plan, population, state, device=device)
    while not stepper.done:
        stepper.step()
    stepper.finalize()
    return state.history


def run(plan: ExperimentPlan, population: Optional[Population] = None,
        sampler=None, device=None) -> RunReport:
    """Execute a compiled plan on ``device`` (CUDA by default; raises
    without a card unless ``device="cpu"``) and return a `RunReport`.
    ``population`` defaults to `materialize(plan.spec)`."""
    dev = resolve(device)
    pop = (population if population is not None
           else materialize(plan.spec, device=dev))
    if sampler is not None:
        pop = dataclasses.replace(pop, sampler=sampler)
    state = init_state(plan, pop, device=dev)
    records = execute(plan, pop, state, device=dev)
    comm = sum(r.comm_time for r in records)
    comp = sum(r.comp_time for r in records)
    return RunReport(
        mode=plan.mode, engine=plan.engine, records=list(records),
        kappa=async_update.communication_efficiency(comm, comp),
        epsilon_spent=(state.accountant.epsilon(plan.spec.privacy.delta)
                       if state.accountant is not None else 0.0),
        final_accuracy=records[-1].accuracy if records else 0.0,
        detections=detection_log(records),
        spec=plan.spec.to_dict(),
        net=state.net,
        final_params=state.params)
