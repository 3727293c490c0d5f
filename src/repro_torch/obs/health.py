"""Fleet health: declarative SLO probes and incident detection.

A copy of `repro.obs.health` (`HealthSpec`, so spec JSON v6 loads in
the port, and `HealthMonitor`): the same stream raises the same
`health.alert` and `health.incident` events in either package.

`HealthSpec` declares *what healthy looks like* — a straggler factor the
slowest nodes must stay under, a per-record byte budget the compressed
uplink must fit, a ceiling on the detector's recent reject rate, a floor
on window occupancy.  `HealthMonitor` evaluates those probes between
records against the running `FleetAnalytics` state and writes what it
finds back into the *same* trace stream everything else records to:

  * ``health.alert``    — an instant the moment a probe trips (probe,
    subject node, observed value, threshold);
  * ``health.incident`` — a span emitted when the condition *clears*
    (or at run end via `finalize`), carrying the full virtual-time
    extent, so Perfetto renders outages as slices and `report` can
    build an incident timeline from the trace alone.

Probes are level-triggered with per-subject dedup: a straggler that
stays slow for forty records is one incident with a forty-record extent,
not forty alerts.  The monitor only *reads* analytics and *emits*
events — it never touches engine state, so runs with health disabled
(the default) are bit-identical to runs without the feature.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .analysis import FleetAnalytics
from .events import TraceEvent, Tracer


@dataclasses.dataclass(frozen=True)
class HealthSpec:
    """Declarative SLO rules / anomaly probes (the `ObsSpec.health` axis).

    Every probe defaults to *off* (threshold 0) — an empty `HealthSpec`
    is rejected by `compile_plan`, enable at least one probe.

      straggler_factor: flag node i when its inter-arrival gap (measured
        cadence, or the run-extent lower bound for barely-seen nodes)
        exceeds ``factor`` times the fleet median (> 1 when set; needs an
        async/buffered schedule — sync rounds have no arrival cadence).
      straggler_min_arrivals: fleet-median arrivals before cadence is
        scored at all (>= 2 — a cold fleet has no baseline).
      bytes_per_record_budget: flag a round/window whose committed upload
        bytes exceed this budget (requires ``network.enabled``).
      reject_rate_threshold: flag when the rejected fraction of the
        trailing ``reject_rate_window`` verdicts exceeds this (in (0, 1];
        requires ``defense.detect`` — the drift signature of an attack
        onset or a mis-tuned trust ring).
      reject_rate_window: trailing verdict count for the rate (>= 1).
      occupancy_floor: flag when mean processed arrivals per recent
        window falls below this fraction of the fleet (in (0, 1)).
      warmup_records: records before any probe may fire (cold-start
        arrival gaps and an empty trust ring look pathological).
    """
    straggler_factor: float = 0.0
    straggler_min_arrivals: int = 3
    bytes_per_record_budget: float = 0.0
    reject_rate_threshold: float = 0.0
    reject_rate_window: int = 16
    occupancy_floor: float = 0.0
    warmup_records: int = 2

    def enabled_probes(self) -> Tuple[str, ...]:
        out = []
        if self.straggler_factor:
            out.append("straggler")
        if self.bytes_per_record_budget:
            out.append("byte_budget")
        if self.reject_rate_threshold:
            out.append("reject_rate")
        if self.occupancy_floor:
            out.append("occupancy")
        return tuple(out)


class _Incident:
    """An open condition: (probe, subject) -> first-trip bookkeeping."""
    __slots__ = ("probe", "subject", "opened_t", "opened_record",
                 "worst", "threshold", "polls")

    def __init__(self, probe: str, subject: Optional[int], t: float,
                 record: int, value: float, threshold: float):
        self.probe = probe
        self.subject = subject
        self.opened_t = t
        self.opened_record = record
        self.worst = value
        self.threshold = threshold
        self.polls = 1

    def update(self, value: float, worse_is_higher: bool) -> None:
        self.polls += 1
        self.worst = (max(self.worst, value) if worse_is_higher
                      else min(self.worst, value))


class HealthMonitor:
    """Evaluate a `HealthSpec` against live `FleetAnalytics` state.

    `evaluate(virt_t, records_done)` is called between records (the
    service's `_pre_dispatch`, or a post-run sweep); `finalize(virt_t)`
    closes whatever is still open at run end.
    """

    def __init__(self, spec: HealthSpec, analytics: FleetAnalytics,
                 tracer: Tracer, n_nodes: int):
        self.spec = spec
        self.analytics = analytics
        self.tracer = tracer
        self.n_nodes = n_nodes
        self.open: Dict[Tuple[str, Optional[int]], _Incident] = {}
        self.closed: List[Dict[str, Any]] = []
        self._last_record = -1
        self._bytes_at_record = 0.0
        self._finalized = False

    # -- probe evaluation ----------------------------------------------------
    def evaluate(self, virt_t: float, records_done: int) -> None:
        if self._finalized or records_done < self.spec.warmup_records:
            # still track the byte watermark so the budget probe measures
            # post-warmup deltas, not the whole cold start at once
            self._note_record(records_done)
            return
        sp, an = self.spec, self.analytics
        trips: Dict[Tuple[str, Optional[int]], Tuple[float, float]] = {}

        if sp.straggler_factor:
            scores = an.straggler_scores(sp.straggler_min_arrivals)
            for node, score in scores.items():
                if score > sp.straggler_factor:
                    trips[("straggler", node)] = (score, sp.straggler_factor)

        if sp.bytes_per_record_budget and records_done > self._last_record:
            delta = an.total_upload_bytes - self._bytes_at_record
            n_rec = records_done - self._last_record
            per_record = delta / n_rec
            if per_record > sp.bytes_per_record_budget:
                trips[("byte_budget", None)] = (
                    per_record, sp.bytes_per_record_budget)

        if sp.reject_rate_threshold:
            rate = an.recent_reject_rate(sp.reject_rate_window)
            if rate is not None and rate > sp.reject_rate_threshold:
                trips[("reject_rate", None)] = (rate,
                                                sp.reject_rate_threshold)

        if sp.occupancy_floor:
            occ = an.recent_occupancy()
            if occ is not None and occ < sp.occupancy_floor:
                trips[("occupancy", None)] = (occ, sp.occupancy_floor)

        self._note_record(records_done)

        # open / refresh tripped conditions, close cleared ones
        for key, (value, threshold) in sorted(
                trips.items(), key=lambda kv: (kv[0][0], kv[0][1] or -1)):
            inc = self.open.get(key)
            if inc is None:
                probe, subject = key
                self.open[key] = _Incident(probe, subject, virt_t,
                                           records_done, value, threshold)
                self._alert(probe, subject, value, threshold, virt_t,
                            records_done)
            else:
                inc.update(value, worse_is_higher=key[0] != "occupancy")
        for key in sorted(self.open.keys() - trips.keys(),
                          key=lambda k: (k[0], k[1] or -1)):
            self._close(self.open.pop(key), virt_t, records_done,
                        resolved=True)

    def finalize(self, virt_t: float, records_done: int) -> None:
        """Close every still-open incident (run end is not resolution —
        the span is tagged ``resolved=False``)."""
        if self._finalized:
            return
        self._finalized = True
        for key in sorted(self.open.keys(), key=lambda k: (k[0],
                                                           k[1] or -1)):
            self._close(self.open.pop(key), virt_t, records_done,
                        resolved=False)

    # -- event emission ------------------------------------------------------
    def _alert(self, probe: str, subject: Optional[int], value: float,
               threshold: float, virt_t: float, record: int) -> None:
        tags: Dict[str, Any] = {"probe": probe, "value": value,
                                "threshold": threshold, "record": record}
        if subject is not None:
            tags["node"] = subject
        self.tracer.instant("health.alert", virt_t=virt_t, **tags)
        self.tracer.metrics.counter("health.alerts").inc()
        self.tracer.metrics.counter(f"health.alerts.{probe}").inc()

    def _close(self, inc: _Incident, virt_t: float, record: int,
               resolved: bool) -> None:
        tags: Dict[str, Any] = {
            "probe": inc.probe, "worst": inc.worst,
            "threshold": inc.threshold, "resolved": resolved,
            "opened_record": inc.opened_record, "closed_record": record,
            "polls": inc.polls}
        if inc.subject is not None:
            tags["node"] = inc.subject
        self.tracer.emit(TraceEvent(
            kind="span", name="health.incident",
            wall_t=self.tracer.clock(), virt_t=inc.opened_t,
            virt_dur=max(0.0, virt_t - inc.opened_t), tags=tags))
        self.tracer.metrics.counter("health.incidents").inc()
        self.tracer.metrics.counter(f"health.incidents.{inc.probe}").inc()
        self.closed.append(dict(tags, opened_t=inc.opened_t,
                                closed_t=virt_t))

    def _note_record(self, records_done: int) -> None:
        if records_done > self._last_record:
            self._last_record = records_done
            self._bytes_at_record = self.analytics.total_upload_bytes
