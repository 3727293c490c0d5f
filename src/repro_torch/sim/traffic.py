"""Time-varying traffic: trace evaluation + the membership-aware sampler.

A copy of `repro.sim.traffic` over the port's `fleet.ClientSampler`.

A `TrafficTrace` (declared on `api.SimSpec`) is a *pure function of
virtual time*: given the trace tuple and a time ``t``, `modulation`
returns the per-node link-rate scale and availability mask in effect.
Purity is the resume contract — a checkpoint restore recomputes the
identical modulation from the restored clocks, no trace state needs
saving.

The service feeds the results into two hooks:

  * the rate scale lands on ``NetSim.rate_scale`` (throttling the
    effective uplink bandwidth of every subsequent link draw);
  * the availability mask lands on a `DynamicSampler` wrapped around the
    population's declared sampler, so regional outages and `SimEvent`
    membership churn drop nodes from sync cohorts / discard their async
    arrivals through the exact same churn path `fleet.AvailabilityTrace`
    uses.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ..fleet import ClientSampler


def region_mask(n_nodes: int, node_frac: float,
                region_start: float) -> np.ndarray:
    """The contiguous (wrapping) regional node block a trace affects."""
    count = max(1, int(round(node_frac * n_nodes)))
    count = min(count, n_nodes)
    start = int(math.floor(region_start * n_nodes)) % n_nodes
    idx = (start + np.arange(count)) % n_nodes
    mask = np.zeros(n_nodes, bool)
    mask[idx] = True
    return mask


def _in_epoch(trace, t: float) -> bool:
    return trace.t_start <= t < trace.t_start + trace.duration_s


def modulation(traces: Sequence, n_nodes: int, t: float
               ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """(rate_scale, up) at virtual time ``t``.

    ``rate_scale`` is a per-node multiplier in (0, 1] — None when no
    bandwidth trace is active (the stationary fast path).  ``up`` is the
    per-node availability mask (False inside an outage epoch's region).
    Bandwidth traces compose multiplicatively; availability conjunctively.
    """
    scale: Optional[np.ndarray] = None
    up = np.ones(n_nodes, bool)
    for trc in traces:
        if trc.kind == "diurnal":
            phase = 2.0 * math.pi * (t - trc.phase_s) / trc.period_s
            s = 1.0 - trc.amplitude * (0.5 + 0.5 * math.sin(phase))
            if scale is None:
                scale = np.ones(n_nodes, np.float64)
            scale *= s
        elif trc.kind == "flash_crowd":
            if _in_epoch(trc, t):
                if scale is None:
                    scale = np.ones(n_nodes, np.float64)
                mask = region_mask(n_nodes, trc.node_frac, trc.region_start)
                scale[mask] *= (1.0 - trc.amplitude)
        elif trc.kind == "outage":
            if _in_epoch(trc, t):
                up &= ~region_mask(n_nodes, trc.node_frac, trc.region_start)
        else:   # compile_plan validates kinds; guard direct callers
            raise ValueError(f"unknown TrafficTrace kind {trc.kind!r}")
    return scale, up


class DynamicSampler(ClientSampler):
    """A `ClientSampler` whose availability is set from outside per
    round/window: the service intersects the wrapped sampler's cohort with
    the current trace/membership ``up`` mask.  With ``inner=None`` and a
    full mask this is exactly `FullParticipation` (same (idx, valid)
    arrays), so attaching the service to a plain spec changes nothing.
    """

    def __init__(self, n_nodes: int, inner: Optional[ClientSampler] = None):
        self.inner = inner
        self.up = np.ones(n_nodes, bool)

    def cohort(self, round_idx, n_nodes):
        if self.inner is None:
            idx = np.arange(n_nodes)
            valid = np.ones(n_nodes, bool)
        else:
            idx, valid = self.inner.cohort(round_idx, n_nodes)
        idx = np.asarray(idx)
        return idx, np.asarray(valid, bool) & self.up[idx]
