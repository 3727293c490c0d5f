"""Execute an `ExperimentPlan`: plan -> engine -> `RunReport`.

Port of the fleet-engine half of `repro.api.run`: `make_engine`, the sync
and async record steppers, `init_state`, `make_stepper`, `execute` and
`run`, and the per-run observability session (`_ObsSession`).  One
record per barrier round (sync) or per n_nodes arrivals (async), exactly
as the reference emits them.  A spec whose `NetworkSpec` names a codec
attaches a `net.NetSim` to the engine: the records then carry encoded
bytes (``bytes_source="encoded"``) and `RunReport.net` the trace
summary.  A spec with ``obs.enabled`` runs inside a tracer scope (events,
record streams, health probes); a spec with a `SimSpec` runs through
`sim.SimService`.  Everything runs on ``device`` ("cuda" unless the
caller passes "cpu").
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from .. import fleet, prng
from .. import obs as _obs
from .. import tree as tree_util
from ..core import async_update
from ..core.accountant import MomentsAccountant
from ..device import resolve
from ..fleet import stages as fleet_stages
from ..net import netsim_from_network
from .plan import ExperimentPlan, SpecError
from .population import Population, materialize
from .report import RoundRecord, RunReport, detection_log
from .spec import SCHEMA_VERSION


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


# ---------------------------------------------------------------------------
# the per-run observability session (ObsSpec -> tracer + sinks + streams)
# ---------------------------------------------------------------------------

class _ObsSession:
    """Materialize one run's `ObsSpec`: build the tracer and its sinks,
    stream `RoundRecord`s as they land, export the Chrome trace and the
    metrics snapshot at the end.  With the spec disabled every method is a
    no-op and no tracer is installed — the run is the untraced run."""

    def __init__(self, plan: ExperimentPlan):
        o = plan.spec.obs
        self.enabled = o.enabled
        self.tracer: Optional[_obs.Tracer] = None
        self.analytics: Optional[_obs.FleetAnalytics] = None
        self.health: Optional[_obs.HealthMonitor] = None
        self._chrome_path = o.chrome_trace
        self._mem: Optional[_obs.MemorySink] = None
        self._events: Optional[_obs.JsonlSink] = None
        self._records: Optional[_obs.JsonlWriter] = None
        self._last_virt_t = 0.0
        self._last_records_done = 0
        if not self.enabled:
            return
        header = {"schema_version": SCHEMA_VERSION, "mode": plan.mode,
                  "engine": plan.engine, "spec": plan.spec.to_dict()}
        sinks = []
        if o.chrome_trace:
            self._mem = _obs.MemorySink()
            sinks.append(self._mem)
        if o.events_jsonl:
            self._events = _obs.JsonlSink(o.events_jsonl,
                                          header=dict(header,
                                                      stream="events"))
            sinks.append(self._events)
        if o.health is not None:
            # the analytics sink sees every event the file sinks see —
            # including the monitor's own alerts/incidents, which it
            # collects but never probes on
            self.analytics = _obs.FleetAnalytics(
                n_nodes=plan.spec.fleet.n_nodes)
            sinks.append(self.analytics)
        self.tracer = _obs.Tracer(sinks=sinks, enabled=True,
                                  stage_timings=o.stage_timings)
        if o.health is not None:
            self.health = _obs.HealthMonitor(
                o.health, self.analytics, self.tracer,
                n_nodes=plan.spec.fleet.n_nodes)
        if o.records_jsonl:
            self._records = _obs.JsonlWriter(o.records_jsonl,
                                             header=dict(header,
                                                         stream="records"))

    def scope(self):
        """The `use_tracer` context the run executes inside (engines and
        `NetSim` pick the tracer up from the process-global slot)."""
        return (_obs.use_tracer(self.tracer) if self.tracer is not None
                else contextlib.nullcontext())

    def record(self, rec: RoundRecord) -> None:
        """Stream one completed round record (called from the history
        hook the moment each record is appended)."""
        if self._records is not None:
            self._records.write({"kind": "record",
                                 **dataclasses.asdict(rec)})

    def history(self) -> Optional[List[RoundRecord]]:
        """An append-hooked record list when ``records_jsonl`` is set
        (swapped in for ``state.history``), else None."""
        if self._records is None:
            return None
        return _StreamingHistory(self.record)

    def poll_health(self, virt_t: float, records_done: int) -> None:
        """Evaluate the health probes between records (no-op without an
        `ObsSpec.health` axis)."""
        if self.health is None:
            return
        self._last_virt_t = virt_t
        self._last_records_done = records_done
        self.health.evaluate(virt_t, records_done)

    def finish(self, report: Optional[RunReport] = None) -> None:
        """Flush everything: close open health incidents, report footer
        on the record stream, metrics snapshot on the event stream, the
        Chrome-trace export, then close every sink."""
        if not self.enabled:
            return
        if self.health is not None:
            # run end closes whatever is still open (tagged unresolved),
            # before the metrics snapshot so incident counters land in it
            t = max(self._last_virt_t,
                    self.analytics.t_max or 0.0)
            self.health.finalize(t, self._last_records_done)
        if self._records is not None:
            if report is not None:
                footer = {k: v for k, v in report.to_dict().items()
                          if k != "records"}
                self._records.write({"kind": "report", **footer})
            self._records.close()
        if self._events is not None:
            snap = self.tracer.metrics.snapshot()
            if snap:
                self._events.writer.write({"kind": "metrics",
                                           "metrics": snap})
        if self._chrome_path and self._mem is not None:
            _obs.write_chrome_trace(self._chrome_path, self._mem.events)
        self.tracer.close()


class _StreamingHistory(list):
    """A record list that streams each append (every stepper appends to
    ``state.history``, so hooking the list streams every path)."""

    def __init__(self, callback):
        super().__init__()
        self._callback = callback

    def append(self, rec) -> None:
        super().append(rec)
        self._callback(rec)


# ---------------------------------------------------------------------------
# engine construction
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# record steppers (one RoundRecord per step)
# ---------------------------------------------------------------------------
#
# Each path is a stepper: `step()` advances the run by one `RoundRecord`,
# `done` says whether the record budget is spent, `finalize()` hands
# node-local state back to the `RunState`.  `execute` drains a stepper;
# `sim.SimService` drives the same steppers record by record through the
# `pre_step` hook (traffic traces, health probes), checkpoints between
# steps via `export_state`/`restore_state` (only at a record boundary,
# where the span accumulators are zero), and swaps steppers mid-run to
# apply `SimEvent` spec mutations.

class _SyncFleetStepper:
    """Barrier rounds on the cohort-batched `FleetEngine`."""

    def __init__(self, plan, pop, state, eng):
        self.plan, self.pop, self.state, self.eng = plan, pop, state, eng
        self.src = "encoded" if eng.net is not None else "analytic"
        eng.load_state(state.residuals, state.key)
        self.emitted = 0
        self.pre_step = None

    @property
    def net(self):
        return self.eng.net

    @property
    def done(self) -> bool:
        return self.emitted >= self.plan.spec.rounds

    def virtual_time(self) -> float:
        h = self.eng.history
        return float(h[-1].t) if h else float(self.eng._t0)

    def step(self) -> None:
        if self.pre_step is not None:
            self.pre_step(self)
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

    # -- checkpoint/resume (sim.SimService) ---------------------------------
    def export_state(self):
        arrays = self.eng.export_sim_state()
        meta = {"emitted": self.emitted,
                "round": int(self.eng.state.round),
                "t0": self.virtual_time()}
        _export_net(self.eng.net, arrays, meta)
        return arrays, meta

    def restore_state(self, arrays, meta) -> None:
        arrays = dict(arrays)
        _restore_net(self.eng.net, arrays, meta)
        self.eng.load_sim_state(arrays)
        self.eng.state.round = int(meta["round"])
        # the barrier clock continues from the checkpointed time (the
        # engine's own history is empty after a restore)
        self.eng._t0 = float(meta["t0"])
        self.state.params = self.eng.params
        self.emitted = int(meta["emitted"])


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
        self.pre_step = None

    @property
    def net(self):
        return self.eng.net

    @property
    def done(self) -> bool:
        return self.processed >= self.plan.total_arrivals

    def virtual_time(self) -> float:
        """The earliest pending arrival (reads the clocks off the card:
        called only where a `pre_step` hook is installed)."""
        arr = self.eng.state.next_arrival.cpu().numpy()
        return float(arr.astype(np.float64)[:self.n].min())

    def step(self) -> None:
        state, eng = self.state, self.eng
        target = min(self.processed + self.n, self.plan.total_arrivals)
        span_bytes = span_comp = span_comm = 0.0
        span_rejected = 0
        rec = None
        while self.processed < target:
            if self.pre_step is not None:
                self.pre_step(self)
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

    # -- checkpoint/resume (sim.SimService) ---------------------------------
    def export_state(self):
        arrays = self.eng.export_sim_state()
        meta = {"emitted": self.emitted, "processed": self.processed,
                "window_idx": int(self.eng._window_idx)}
        _export_net(self.eng.net, arrays, meta)
        return arrays, meta

    def restore_state(self, arrays, meta) -> None:
        arrays = dict(arrays)
        _restore_net(self.eng.net, arrays, meta)
        self.eng.load_sim_state(arrays)
        self.state.params = self.eng.params
        self.emitted = int(meta["emitted"])
        self.processed = int(meta["processed"])
        # the window index seeds the cohort sampler's round stream
        self.eng._window_idx = int(meta["window_idx"])


class _BufferedFleetStepper(_AsyncFleetStepper):
    """Buffered (FedBuff) windows: the arrival budget window by window,
    one record per window, with no record boundary inside the event
    loop's cadence."""

    def step(self) -> None:
        if self.pre_step is not None:
            self.pre_step(self)
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


def _export_net(net, arrays, meta) -> None:
    """Fold the `NetSim` counter/trace state into a stepper snapshot."""
    if net is not None:
        counters, columns = net.export_sim_state()
        arrays["net_counters"] = counters
        meta["net_trace"] = columns


def _restore_net(net, arrays, meta) -> None:
    counters = arrays.pop("net_counters", None)
    if net is not None and counters is not None:
        net.restore_sim_state(counters, meta.get("net_trace"))


# ---------------------------------------------------------------------------
# top-level execution
# ---------------------------------------------------------------------------

def make_stepper(plan: ExperimentPlan, population: Population,
                 state: RunState, device=None):
    """Build the record stepper a plan selects (engines built here pick up
    any installed obs tracer — call inside the session scope)."""
    if population.n_nodes != plan.spec.fleet.n_nodes:
        raise SpecError(
            f"population has {population.n_nodes} nodes but the plan was "
            f"compiled for fleet.n_nodes={plan.spec.fleet.n_nodes} — the "
            f"arrival budget and record cadence derive from the spec, so "
            f"a mismatched population would run the wrong experiment")
    tr = _obs.get_tracer()
    if tr.enabled:
        # ground truth for trace-only detection-quality reconstruction:
        # which nodes actually run the attack
        tr.instant("fleet.population", n_nodes=population.n_nodes,
                   malicious=sorted(population.malicious_ids))
    eng = make_engine(plan, population, device=device)
    if plan.mode == "sync":
        return _SyncFleetStepper(plan, population, state, eng)
    if plan.mixing == "buffered":
        return _BufferedFleetStepper(plan, population, state, eng)
    return _AsyncFleetStepper(plan, population, state, eng)


def execute(plan: ExperimentPlan, population: Population, state: RunState,
            device=None, session: Optional[_ObsSession] = None
            ) -> List[RoundRecord]:
    """Run ``plan`` over ``population``, appending records to
    ``state.history`` and advancing params/key/residuals/accountant.
    With a health-carrying obs ``session`` the probes are polled between
    records through the stepper's ``pre_step`` hook."""
    stepper = make_stepper(plan, population, state, device=device)
    if session is not None and session.health is not None:
        def _poll(st) -> None:
            session.poll_health(st.virtual_time(), len(state.history))
        stepper.pre_step = _poll
    while not stepper.done:
        stepper.step()
    stepper.finalize()
    return state.history


def run(plan: ExperimentPlan, population: Optional[Population] = None,
        sampler=None, device=None) -> RunReport:
    """Execute a compiled plan on ``device`` (CUDA by default; raises
    without a card unless ``device="cpu"``) and return a `RunReport`.
    ``population`` defaults to `materialize(plan.spec)`.  Plans carrying a
    `SimSpec` run through `sim.SimService` (the same report, plus its
    checkpoints, traces and events)."""
    if plan.spec.sim is not None:
        from ..sim import SimService     # lazy: api must not import sim
        return SimService(plan, population=population, sampler=sampler,
                          device=device).run()
    dev = resolve(device)
    pop = (population if population is not None
           else materialize(plan.spec, device=dev))
    if sampler is not None:
        pop = dataclasses.replace(pop, sampler=sampler)
    state = init_state(plan, pop, device=dev)
    session = _ObsSession(plan)
    streamed = session.history()
    if streamed is not None:
        state.history = streamed
    try:
        with session.scope():
            records = execute(plan, pop, state, device=dev, session=session)
    except BaseException:
        session.finish(None)        # flush what streamed before the crash
        raise
    comm = sum(r.comm_time for r in records)
    comp = sum(r.comp_time for r in records)
    report = RunReport(
        mode=plan.mode, engine=plan.engine, records=list(records),
        kappa=async_update.communication_efficiency(comm, comp),
        epsilon_spent=(state.accountant.epsilon(plan.spec.privacy.delta)
                       if state.accountant is not None else 0.0),
        final_accuracy=records[-1].accuracy if records else 0.0,
        detections=detection_log(records),
        spec=plan.spec.to_dict(),
        net=state.net,
        final_params=state.params)
    session.finish(report)
    return report
