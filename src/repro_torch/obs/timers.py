"""Host-side stage timers + the kernels profiling mode.

Port of `repro.obs.timers`.  CUDA launches return before the card has
run them, so `time.perf_counter` around a launch measures the enqueue,
not the work.  Everything here is fenced:

  * `fence(x)` — record a CUDA event on the current stream of each card
    that holds a tensor of ``x`` and wait on that event (not a
    `torch.cuda.synchronize()` of every stream).  The identity on CPU
    tensors and host values; walks nested dicts, lists and tuples.
  * `timed_stage(tracer, name)` — a span context for one pipeline stage
    (window selection, the device program, net draw/commit, evaluation).
    The caller fences the stage's outputs via ``st.fence(out)`` before
    the context exits, so the span's wall duration covers the device
    work.  A no-op unless the tracer is enabled with ``stage_timings``:
    untimed runs keep the card's queue running ahead of the host.
  * `bench_kernel(name, fn, *args)` — warmup + timing loop, µs per call
    (CUDA events when ``fn`` returns tensors on a card, the host clock
    otherwise), and a ``kernel.<name>`` counter event + a
    ``kernel.us_per_call`` histogram sample into the tracer.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from .events import Tracer, get_tracer
from .metrics import SECONDS_EDGES


def _cuda_devices(x: Any, out: set) -> set:
    """The CUDA devices of every tensor in a nest of dicts/lists/tuples."""
    if isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif getattr(x, "is_cuda", False):
        out.add(x.device)
    return out


def fence(x: Any) -> Any:
    """Wait until the work queued so far on the current stream of each
    card holding a tensor of ``x`` has run; return ``x`` unchanged."""
    devices = _cuda_devices(x, set())
    if devices:
        import torch
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
    return x


class _TimedStage:
    """Open stage timer: `fence` outputs inside, span emitted at exit."""
    __slots__ = ("_span",)

    def __init__(self, tracer: Tracer, name: str, virt_t, tags):
        self._span = tracer.span(f"stage.{name}", virt_t=virt_t, **tags)

    def fence(self, x: Any) -> Any:
        return fence(x)

    def set(self, **tags) -> None:
        self._span.set(**tags)

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)


class _NullStage:
    """Disabled-path stage: no clock reads, `fence` is the identity."""
    __slots__ = ()

    def fence(self, x: Any) -> Any:
        return x

    def set(self, **tags) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_STAGE = _NullStage()


def timed_stage(tracer: Optional[Tracer], name: str,
                virt_t: Optional[float] = None, **tags):
    """Span context for one host-observed pipeline stage.

        with timed_stage(self.obs, "window.device", window=w) as st:
            out = self._window_fn(...)
            st.fence(out)           # wait for the card before the clock stops
    """
    tracer = tracer if tracer is not None else get_tracer()
    if not (tracer.enabled and tracer.stage_timings):
        return _NULL_STAGE
    return _TimedStage(tracer, name, virt_t, tags)


# ---------------------------------------------------------------------------
# kernels profiling mode
# ---------------------------------------------------------------------------

def bench_kernel(name: str, fn, *args, iters: int = 3, warmup: int = 1,
                 tracer: Optional[Tracer] = None) -> float:
    """Fenced kernel microbenchmark: µs per call over ``iters`` timed
    iterations after ``warmup`` untimed ones (build + first touch).

    When ``fn`` returns tensors on a card the loop is timed with CUDA
    events on that card's current stream; otherwise with the host clock.
    When the (global or injected) tracer is enabled, each measurement
    lands in the stream as a ``kernel.<name>`` counter event (value =
    µs/call, tags carry iters) and a shared ``kernel.us_per_call``
    histogram sample.
    """
    tracer = tracer if tracer is not None else get_tracer()
    out = None
    for _ in range(max(1, warmup)):
        out = fence(fn(*args))
    devices = _cuda_devices(out, set())
    if devices:
        import torch
        dev = next(iter(devices))
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            out = fn(*args)
        end.record(stream)
        end.synchronize()
        us = start.elapsed_time(end) / iters * 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        us = (time.perf_counter() - t0) / iters * 1e6
    if tracer.enabled:
        tracer.counter(f"kernel.{name}", us, iters=iters)
        tracer.metrics.histogram("kernel.us_per_call",
                                 [e * 1e6 for e in SECONDS_EDGES]).observe(us)
    return us
