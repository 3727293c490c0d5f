"""Structured event tracing: `TraceEvent` + the process-global `Tracer`.

A copy of `repro.obs.events` (stdlib only, so the port keeps its own):
the same event kinds, fields and JSON, so a stream written by either
package reads in the other.

The paper's claims are time-series claims — comm-overhead curves over
virtual time, async window composition, detection firing per arrival — so
the repro needs a structured event stream, not prints.  A `TraceEvent`
carries *both* clocks: host wall time (``wall_t``/``dur``, from
`time.perf_counter`) and the simulation's virtual time (``virt_t``/
``virt_dur``, the engines' arrival clocks), plus free-form tags
(``node``/``round``/``window``/...) that the sinks turn into tracks.

Three event kinds:

  * ``span``    — a named interval (an arrival window, a pipeline stage);
    emitted once at exit with its start time and duration.  Spans nest —
    `Tracer.span` is a context manager.
  * ``instant`` — a point event (one arrival, one detection verdict).
  * ``counter`` — a named sample (bytes uploaded, window size).

The tracer is **explicitly injectable and no-op when disabled**: every
hot-path call sites `if tracer.enabled:` first (one attribute read), and
the disabled `span()` returns a shared null context manager, so
untraced runs pay nothing.  A process-global default
(`get_tracer`/`set_tracer`/`use_tracer`) lets layers that never see the
`api.ObsSpec` (kernels benchmarks, the net bridge) share one stream.

Zero dependencies beyond the stdlib — `repro_torch.obs` sits below every
other subsystem and must import nothing from them.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

EVENT_KINDS = ("span", "instant", "counter")


@dataclass
class TraceEvent:
    """One structured trace record (see module docstring for the kinds)."""
    kind: str                           # span | instant | counter
    name: str
    wall_t: float                       # host perf_counter seconds
    virt_t: Optional[float] = None      # simulation virtual time (seconds)
    dur: Optional[float] = None         # span: host wall duration
    virt_dur: Optional[float] = None    # span: virtual-time duration
    value: Optional[float] = None       # counter: the sampled value
    tags: Dict[str, Any] = field(default_factory=dict)
    seq: int = 0                        # per-tracer emission order

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "name": self.name,
                             "wall_t": self.wall_t, "seq": self.seq}
        for k in ("virt_t", "dur", "virt_dur", "value"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.tags:
            d["tags"] = self.tags
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        if d.get("kind") not in EVENT_KINDS:
            raise ValueError(f"TraceEvent.kind {d.get('kind')!r} not in "
                             f"{EVENT_KINDS}")
        return cls(kind=d["kind"], name=d["name"], wall_t=d["wall_t"],
                   virt_t=d.get("virt_t"), dur=d.get("dur"),
                   virt_dur=d.get("virt_dur"), value=d.get("value"),
                   tags=dict(d.get("tags", {})), seq=int(d.get("seq", 0)))


class _NullSpan:
    """The shared do-nothing context manager a disabled tracer hands out."""
    __slots__ = ()

    def set(self, **tags) -> None:
        pass

    def set_virtual(self, virt_t=None, virt_end=None) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span: emitted as one `TraceEvent` when the context exits."""
    __slots__ = ("_tracer", "name", "virt_t", "virt_end", "tags", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 virt_t: Optional[float], virt_end: Optional[float],
                 tags: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.virt_t = virt_t
        self.virt_end = virt_end
        self.tags = tags
        self._t0 = 0.0

    def set(self, **tags) -> None:
        """Attach tags discovered mid-span (window composition counts,
        byte totals) before the span closes."""
        self.tags.update(tags)

    def set_virtual(self, virt_t: Optional[float] = None,
                    virt_end: Optional[float] = None) -> None:
        if virt_t is not None:
            self.virt_t = virt_t
        if virt_end is not None:
            self.virt_end = virt_end

    def __enter__(self):
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer.clock()
        virt_dur = (self.virt_end - self.virt_t
                    if self.virt_end is not None and self.virt_t is not None
                    else None)
        self._tracer.emit(TraceEvent(
            kind="span", name=self.name, wall_t=self._t0, dur=t1 - self._t0,
            virt_t=self.virt_t, virt_dur=virt_dur, tags=self.tags))
        return False


class Tracer:
    """The event stream head: fan events out to sinks, own a metrics
    registry, stamp emission order.

    ``enabled=False`` (the default of the process-global tracer) makes
    every method a near-free no-op — instrumented code guards with
    ``if tracer.enabled:`` for zero-cost disabled paths, but calling
    through is also safe.
    """

    def __init__(self, sinks: Iterable = (), enabled: bool = True,
                 clock=time.perf_counter, metrics=None,
                 stage_timings: bool = False):
        self.sinks: List = list(sinks)
        self.enabled = bool(enabled)
        # measurement mode: fence + time host pipeline stages (waits on
        # the card after each stage, so it is a separate opt-in from
        # `enabled`)
        self.stage_timings = bool(stage_timings)
        self.clock = clock
        self._seq = itertools.count()
        if metrics is None:
            from .metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self.metrics = metrics

    # -- emission -----------------------------------------------------------
    def emit(self, event: TraceEvent) -> None:
        if not self.enabled:
            return
        event.seq = next(self._seq)
        for sink in self.sinks:
            sink.emit(event)

    def instant(self, name: str, virt_t: Optional[float] = None,
                **tags) -> None:
        if not self.enabled:
            return
        self.emit(TraceEvent(kind="instant", name=name, wall_t=self.clock(),
                             virt_t=virt_t, tags=tags))

    def counter(self, name: str, value: float,
                virt_t: Optional[float] = None, **tags) -> None:
        if not self.enabled:
            return
        self.emit(TraceEvent(kind="counter", name=name, wall_t=self.clock(),
                             virt_t=virt_t, value=float(value), tags=tags))

    def span(self, name: str, virt_t: Optional[float] = None,
             virt_end: Optional[float] = None, **tags):
        """Nestable span context manager; a disabled tracer returns a
        shared null context (no allocation, no clock read)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, virt_t, virt_end, tags)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


# ---------------------------------------------------------------------------
# the process-global tracer (disabled by default: untraced runs pay nothing)
# ---------------------------------------------------------------------------

_GLOBAL_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The current process-global tracer (a disabled no-op unless a run
    installed one via `set_tracer`/`use_tracer`)."""
    return _GLOBAL_TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global default; returns the
    previous one so callers can restore it."""
    global _GLOBAL_TRACER
    prev = _GLOBAL_TRACER
    _GLOBAL_TRACER = tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Scoped install: the global tracer is ``tracer`` inside the with
    block and restored after — how `api.run` scopes one run's stream."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
