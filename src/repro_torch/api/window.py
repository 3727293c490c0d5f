"""Pluggable window policies for the asynchronous schedules — a copy of
`repro.api.window`.

The `AsyncFleetEngine` batches every arrival inside a virtual-time window
[t0, t0 + W).  How long W should be is a *scheduling policy*, not a number:
the parity-safe choice (min node compute time — no node can re-arrive
inside its own window, so event-loop arrival order is preserved) trades
throughput for exactness, while a load-aware window targets a fixed number
of arrivals per device dispatch.  Policies are declarative objects on
`SchedulePolicy.window` so new windowing strategies (the ROADMAP's
load-aware scheduling) land as policy classes instead of more config
fields.

A policy resolves to the engine's ``window=`` argument:

  * ``None``  — the engine's parity-safe auto window;
  * a float   — an explicit virtual-time window length in seconds.

Resolution happens at run time because the answer can depend on the
materialized fleet (per-node compute/bandwidth in `NodeProfile`).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import ClassVar, Dict, Optional, Type

import numpy as np


class WindowPolicy:
    """Base class: maps a materialized fleet to a window length."""

    kind: ClassVar[str] = "base"

    def resolve(self, profile, bytes_per_node: float) -> Optional[float]:
        """Window length in virtual seconds, or None for the engine's
        parity-safe auto window.  ``profile`` is a `fleet.NodeProfile`."""
        raise NotImplementedError

    def to_dict(self) -> Dict:
        d = {"kind": self.kind}
        for f in fields(self):  # type: ignore[arg-type]
            d[f.name] = getattr(self, f.name)
        return d


_REGISTRY: Dict[str, Type[WindowPolicy]] = {}


def _register(cls: Type[WindowPolicy]) -> Type[WindowPolicy]:
    _REGISTRY[cls.kind] = cls
    return cls


def window_policy_from_dict(d: Dict) -> WindowPolicy:
    d = dict(d)
    kind = d.pop("kind", None)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown window policy kind {kind!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[kind](**d)


@_register
@dataclass(frozen=True)
class AutoWindow(WindowPolicy):
    """Parity-safe conservative window: the engine picks the minimum node
    compute time, preserving the sequential event loop's arrival order
    exactly (the mode the sequential-parity tests run in)."""

    kind: ClassVar[str] = "auto"

    def resolve(self, profile, bytes_per_node: float) -> Optional[float]:
        return None


@_register
@dataclass(frozen=True)
class FixedWindow(WindowPolicy):
    """An explicit virtual-time window length in seconds."""

    seconds: float = 1.0
    kind: ClassVar[str] = "fixed"

    def resolve(self, profile, bytes_per_node: float) -> Optional[float]:
        return float(self.seconds)


@_register
@dataclass(frozen=True)
class TargetArrivalsWindow(WindowPolicy):
    """Load-aware windowing: size the window so ~``target_arrivals``
    updates land per device dispatch (the ROADMAP's
    target-arrivals-per-window item for the buffered mode).

    Each node re-arrives with period ``compute_i + upload_i`` once the
    pipeline is warm, so the fleet's steady-state arrival rate is
    Σ 1/(compute_i + bytes/bandwidth_i) and the window that catches
    ``target_arrivals`` of them is ``target / rate``.  Larger targets mean
    fewer, fatter dispatches — coarser than the conservative auto window
    by design (FedBuff-style buffered aggregation, where arrival order
    inside the buffer no longer matters).
    """

    target_arrivals: int = 8
    kind: ClassVar[str] = "target_arrivals"

    def resolve(self, profile, bytes_per_node: float) -> Optional[float]:
        comp = np.asarray(profile.compute_s, np.float64)
        bw = np.asarray(profile.bandwidth_bps, np.float64)
        period = comp + bytes_per_node / bw
        rate = float(np.sum(1.0 / period))
        return float(self.target_arrivals) / rate
