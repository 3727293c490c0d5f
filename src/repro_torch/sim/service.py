"""The always-on simulation service: a compiled `ExperimentPlan` driven
one record at a time, with checkpoint/resume, traffic-trace modulation,
and mid-run `SimEvent` spec mutation.

Port of `repro.sim.service` on the port's steppers, on ``device`` ("cuda"
unless the caller passes "cpu").  Its checkpoints are the reference's
files: a checkpoint the JAX service wrote resumes here.  On a mesh
topology every rank drives its own service; only rank 0 writes the
checkpoint files, and every rank reads them to resume.

`api.run` executes a plan as a batch: build a stepper, drain it, report.
`SimService` owns the same stepper but stays in the loop between records:

  * **checkpoint/resume** — `checkpoint()` snapshots the *complete* run
    state (stepper arrays + loop metadata, record history, accountant,
    sampler RNG, membership, the current — possibly mutated — spec)
    through `repro_torch.checkpointing`; `SimService.resume(path)` rebuilds the
    service and continues bit-exactly: the resumed trajectory equals the
    uninterrupted one record for record.  Snapshots are only taken at
    record boundaries, where every span accumulator is exactly zero.
  * **traffic traces** — before each engine dispatch the service
    evaluates `SimSpec.traces` at the stepper's virtual time and installs
    the result: per-node rate scales on ``NetSim.rate_scale``,
    availability on the `DynamicSampler` it wraps around the population's
    sampler.  Traces are pure in virtual time, so they need no state in
    the checkpoint.
  * **spec mutation** — `SimSpec.events` fire between records: the
    service exports the stepper's state, applies the event to the spec
    (`api.apply_sim_event`), recompiles, rebuilds the stepper for the new
    plan, and restores the exported state into it.  Node join/leave
    events just edit the membership mask.  Attack onset/offset events
    rematerialize the population (malicious shards are spec-derived), so
    they require the default spec-materialized population.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..api.plan import ExperimentPlan, compile_plan
from ..api.population import materialize
from ..api.report import RoundRecord, RunReport, detection_log
from ..api.run import _ObsSession, engine_name, init_state, make_stepper
from ..api.spec import ExperimentSpec, SimSpec, apply_sim_event
from ..checkpointing import load_checkpoint, read_manifest, save_checkpoint
from ..core import async_update
from ..device import resolve
from ..fleet.mesh import barrier, is_writer
from .traffic import DynamicSampler, modulation


def _record_to_json(r: RoundRecord) -> dict:
    """A RoundRecord as JSON-native scalars (numpy floats don't dump).
    json round-trips floats exactly (repr-based), so replayed histories
    stay bit-equal to the uninterrupted run's."""
    return {"t": float(r.t), "version": int(r.version),
            "accuracy": float(r.accuracy), "comm_bytes": float(r.comm_bytes),
            "comp_time": float(r.comp_time), "comm_time": float(r.comm_time),
            "n_rejected": int(r.n_rejected), "bytes_source": r.bytes_source}


class SimService:
    """Drive one experiment as a long-running, interruptible simulation.

    Args:
      plan_or_spec: a compiled `ExperimentPlan` or an `ExperimentSpec`
        (compiled here).  The spec's `SimSpec` (``spec.sim``) supplies the
        traces/events/checkpoint policy; a plan without one runs with an
        empty `SimSpec` — bit-identical to `api.run`.
      population: an explicit population (defaults to the spec-derived
        synthetic fleet).  Incompatible with attack events, which must
        rematerialize the population mid-run.
      sampler: overrides the population's participation model.
      checkpoint_dir / checkpoint_every: override the `SimSpec` policy.
      device: where the run lives ("cuda" by default; raises without a
        card unless "cpu").
    """

    def __init__(self, plan_or_spec, *, population=None, sampler=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None, device=None):
        plan = (plan_or_spec if isinstance(plan_or_spec, ExperimentPlan)
                else compile_plan(plan_or_spec))
        spec = plan.spec
        sim = spec.sim if spec.sim is not None else SimSpec()
        if population is not None and any(e.kind == "attack"
                                          for e in sim.events):
            raise ValueError(
                "SimService: attack SimEvents rematerialize the population "
                "(malicious shards are spec-derived) and so require the "
                "default spec-materialized population, not an external one")
        self.device = resolve(device)
        self.plan = plan
        self.spec = spec            # mutates as events apply
        self.base_spec = spec       # what the final report is labelled with
        self.checkpoint_dir = (checkpoint_dir if checkpoint_dir is not None
                               else sim.checkpoint_dir)
        self.checkpoint_every = (checkpoint_every if checkpoint_every
                                 is not None else sim.checkpoint_every)
        if self.checkpoint_every and self.checkpoint_dir is None:
            raise ValueError("SimService: checkpoint_every > 0 needs a "
                             "checkpoint_dir")
        self._external_pop = population is not None
        self._ext_sampler = sampler
        self.records_done = 0
        self.event_cursor = 0
        self.resumed_from: Optional[str] = None
        self.resume_round: Optional[int] = None
        self._finalized = False
        self._session_done = False
        self._final_report: Optional[RunReport] = None

        pop = (population if population is not None
               else materialize(spec, device=self.device))
        if sampler is not None:
            pop = dataclasses.replace(pop, sampler=sampler)
        self.n_nodes = pop.n_nodes
        self.membership = np.ones(pop.n_nodes, bool)
        # availability indirection: traces and node join/leave flow through
        # this sampler; with no traces/events it reproduces the wrapped
        # sampler (or FullParticipation) exactly
        self.dyn = DynamicSampler(pop.n_nodes, inner=pop.sampler)
        pop = dataclasses.replace(pop, sampler=self.dyn)
        self.pop = pop
        self.state = init_state(plan, pop, device=self.device)
        self.session = _ObsSession(plan)
        streamed = self.session.history()
        if streamed is not None:
            self.state.history = streamed
        with self.session.scope():   # engines bind the tracer at build time
            self.stepper = make_stepper(plan, pop, self.state,
                                        device=self.device)
        self.stepper.pre_step = self._pre_dispatch

    # -- driving -------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.stepper.done

    def virtual_time(self) -> float:
        return self.stepper.virtual_time()

    def step(self) -> None:
        """Advance the run by exactly one `RoundRecord`: fire due events,
        dispatch, heartbeat, auto-checkpoint."""
        if self.stepper.done:
            raise RuntimeError("SimService.step: run already complete")
        self._apply_due_events()
        with self.session.scope():
            self.stepper.step()
        self.records_done += 1
        tr = self.session.tracer
        if tr is not None and tr.enabled:
            rec = self.state.history[-1]
            tr.metrics.counter("sim.records").inc()
            tr.instant("sim.heartbeat", round=self.records_done,
                       t=float(rec.t), accuracy=float(rec.accuracy))
        if (self.checkpoint_every
                and self.records_done % self.checkpoint_every == 0):
            self.checkpoint()

    def run(self, max_records: Optional[int] = None) -> RunReport:
        """Drain the run (or ``max_records`` more records) and report.
        A full drain finalizes and closes the obs session; a partial one
        returns an interim report and leaves the service live."""
        end = (None if max_records is None
               else self.records_done + max_records)
        try:
            while not self.stepper.done and (end is None
                                             or self.records_done < end):
                self.step()
        except BaseException:
            if not self._session_done:
                self._session_done = True
                self.session.finish(None)
            raise
        if self.stepper.done:
            return self.finish()
        return self.report()

    def finish(self) -> RunReport:
        """Finalize: hand engine state back, build the report, flush obs."""
        if self._final_report is None:
            if not self._finalized:
                self.stepper.finalize()
                self._finalized = True
            report = self.report()
            if not self._session_done:
                self._session_done = True
                self.session.finish(report)
            self._final_report = report
        return self._final_report

    def report(self) -> RunReport:
        """The run so far as a `RunReport` (the batch `api.run` schema,
        plus resume provenance)."""
        records = list(self.state.history)
        comm = sum(r.comm_time for r in records)
        comp = sum(r.comp_time for r in records)
        net = self.state.net
        if net is None and self.stepper.net is not None:
            net = self.stepper.net.summary()
        acct = self.state.accountant
        return RunReport(
            mode=self.plan.mode, engine=engine_name(self.plan),
            records=records,
            kappa=async_update.communication_efficiency(comm, comp),
            epsilon_spent=(acct.epsilon(self.spec.privacy.delta)
                           if acct is not None else 0.0),
            final_accuracy=records[-1].accuracy if records else 0.0,
            detections=detection_log(records),
            spec=self.base_spec.to_dict(),
            net=net,
            resumed_from=self.resumed_from,
            resume_round=self.resume_round,
            final_params=self.state.params)

    # -- traffic modulation (pre-dispatch hook on the stepper) ---------------
    def _pre_dispatch(self, stepper) -> None:
        sim = self.spec.sim
        traces = sim.traces if sim is not None else ()
        up = self.membership
        scale = None
        if traces:
            scale, trace_up = modulation(traces, self.n_nodes,
                                         stepper.virtual_time())
            up = up & trace_up
        if not up.any():
            # a sync barrier round over zero nodes would average nothing
            # (and an async window would churn every slot): degrade to the
            # membership mask instead of starving the fleet entirely
            up = self.membership
            tr = self.session.tracer
            if tr is not None and tr.enabled:
                tr.metrics.counter("sim.forced_up").inc()
        self.dyn.up = up
        net = stepper.net
        if net is not None:
            net.rate_scale = scale
        # fleet-health probes ride the same between-records seam: they
        # read the session's streaming analytics and emit health.alert/
        # health.incident events (no-op without an ObsSpec.health axis)
        self.session.poll_health(stepper.virtual_time(), self.records_done)

    # -- SimEvent timeline ---------------------------------------------------
    def _apply_due_events(self) -> None:
        sim = self.spec.sim
        if sim is None:
            return
        events = sim.events
        while (self.event_cursor < len(events)
               and events[self.event_cursor].at_round <= self.records_done):
            ev = events[self.event_cursor]
            self.event_cursor += 1
            tr = self.session.tracer
            if tr is not None and tr.enabled:
                tr.instant("sim.event", kind=ev.kind,
                           at_round=int(ev.at_round), payload=dict(ev.payload))
                tr.metrics.counter("sim.events").inc()
            if ev.kind == "nodes":
                self._apply_membership(ev)
            else:
                self._rebuild(apply_sim_event(self.spec, ev))

    def _apply_membership(self, ev) -> None:
        for node in ev.payload.get("leave", ()):
            self.membership[int(node)] = False
        for node in ev.payload.get("join", ()):
            self.membership[int(node)] = True
        # keep the spec timeline consistent for checkpoints: the manifest
        # stores the mutated spec + the event cursor, so replayed events
        # are exactly the not-yet-applied suffix
        self.spec = apply_sim_event(self.spec, ev)

    def _rebuild(self, new_spec: ExperimentSpec) -> None:
        """Swap the stepper for one compiled from ``new_spec``, carrying
        the full run state across (`compile_plan` already validated every
        event's cumulative spec)."""
        arrays, smeta = self.stepper.export_state()
        plan = compile_plan(new_spec)
        if self._external_pop:
            pop = self.pop      # ctor forbids attack events for this case
        else:
            # rematerialize: attack events change which shards are poisoned.
            # The DynamicSampler (and its wrapped sampler's advanced RNG)
            # carries over — events cannot change the participation model.
            base = materialize(new_spec, device=self.device)
            if self._ext_sampler is not None:
                base = dataclasses.replace(base, sampler=self._ext_sampler)
            pop = dataclasses.replace(base, sampler=self.dyn)
        self.plan, self.spec, self.pop = plan, new_spec, pop
        with self.session.scope():
            self.stepper = make_stepper(plan, pop, self.state,
                                        device=self.device)
            self.stepper.restore_state(arrays, smeta)
        self.stepper.pre_step = self._pre_dispatch

    # -- checkpoint/resume ---------------------------------------------------
    def checkpoint(self, path: Optional[str] = None) -> str:
        """Snapshot the complete run state at the current record boundary.
        Returns the checkpoint base path (``<base>.npz`` + ``<base>.json``)."""
        if path is None:
            if self.checkpoint_dir is None:
                raise ValueError("SimService.checkpoint: no path given and "
                                 "no checkpoint_dir configured")
            path = os.path.join(self.checkpoint_dir,
                                f"ckpt_{self.records_done:06d}")
        arrays, smeta = self.stepper.export_state()     # every rank
        tree = {"stepper": arrays,
                "membership": np.asarray(self.membership, bool)}
        extra = {
            "sim_checkpoint": 1,
            "spec": self.spec.to_dict(),
            "base_spec": self.base_spec.to_dict(),
            "records_done": int(self.records_done),
            "event_cursor": int(self.event_cursor),
            "stepper": smeta,
            "history": [_record_to_json(r) for r in self.state.history],
            "resumed_from": self.resumed_from,
            "resume_round": self.resume_round,
        }
        acct = self.state.accountant
        if acct is not None:
            # the RDP vector is accumulated by repeated adds — snapshot the
            # array itself, not steps*increment (bitwise != in general)
            tree["accountant_rdp"] = np.asarray(acct._rdp, np.float64)
            extra["accountant_steps"] = int(acct.steps)
        inner = self.dyn.inner
        if inner is not None and hasattr(inner, "rng"):
            extra["sampler_rng"] = inner.rng.bit_generator.state
        if is_writer():
            save_checkpoint(path, tree, step=self.records_done, extra=extra)
        barrier()           # no rank reads the files before they exist
        tr = self.session.tracer
        if tr is not None and tr.enabled:
            tr.instant("sim.checkpoint", round=int(self.records_done),
                       path=path)
            tr.metrics.counter("sim.checkpoints").inc()
        return path

    @classmethod
    def resume(cls, path: str, *, population=None, sampler=None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: Optional[int] = None,
               device=None) -> "SimService":
        """Rebuild a service from a `checkpoint()` snapshot (this
        package's or the reference's) and continue bit-exactly.  The
        manifest carries the spec as mutated by every event already
        applied, so the rebuilt plan matches the snapshot's shapes; the
        event cursor skips the applied prefix."""
        meta = read_manifest(path).get("extra", {})
        if not meta.get("sim_checkpoint"):
            raise ValueError(f"{path!r} is not a SimService checkpoint "
                             "(missing sim manifest metadata)")
        spec = ExperimentSpec.from_dict(meta["spec"])
        svc = cls(compile_plan(spec), population=population, sampler=sampler,
                  checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every, device=device)
        # template tree from the freshly-built service (same spec => same
        # structure/shapes/dtypes), then overwrite from the snapshot
        like_arrays, _ = svc.stepper.export_state()
        like = {"stepper": like_arrays,
                "membership": np.asarray(svc.membership, bool)}
        if svc.state.accountant is not None:
            like["accountant_rdp"] = np.zeros_like(
                svc.state.accountant._rdp)
        tree, _step = load_checkpoint(path, like)
        svc.stepper.restore_state(tree["stepper"], meta["stepper"])
        svc.membership = np.asarray(tree["membership"], bool)
        if svc.state.accountant is not None and "accountant_rdp" in tree:
            svc.state.accountant._rdp = np.asarray(tree["accountant_rdp"],
                                                   np.float64)
            svc.state.accountant.steps = int(meta.get("accountant_steps", 0))
        # replay the record history through the (possibly streaming) list:
        # the obs records_jsonl stream is rebuilt record for record
        history: List[RoundRecord] = [RoundRecord(**r)
                                      for r in meta.get("history", [])]
        svc.state.history.clear()
        for rec in history:
            svc.state.history.append(rec)
        inner = svc.dyn.inner
        rng_state = meta.get("sampler_rng")
        if rng_state is not None and inner is not None \
                and hasattr(inner, "rng"):
            inner.rng.bit_generator.state = rng_state
        svc.records_done = int(meta["records_done"])
        svc.event_cursor = int(meta["event_cursor"])
        svc.base_spec = ExperimentSpec.from_dict(meta["base_spec"])
        svc.resumed_from = path
        svc.resume_round = svc.records_done
        tr = svc.session.tracer
        if tr is not None and tr.enabled:
            tr.instant("sim.resume", round=svc.records_done, path=path)
        return svc
