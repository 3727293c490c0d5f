"""The fleet-health axis of the spec (`ObsSpec.health`).

A plain-dataclass copy of `repro.obs.health.HealthSpec`, so spec JSON v6
loads in the port.  The health monitor itself is part of the
observability layer, which is not ported yet (`api.compile_plan` raises
NotImplementedError for ``obs.enabled``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
