"""`repro_torch.obs`: structured event tracing, metrics, and profiling hooks.

Port of `repro.obs`, the observability layer under the whole
fleet/net/kernel stack.  Everything but `timers` is a stdlib copy of the
reference module of the same name, so the two packages write and read
the same JSONL streams:

  * `events`  — `TraceEvent` (span/instant/counter, wall + virtual time,
    node/round/window tags), the nestable-`span()` `Tracer`, and the
    process-global injectable default (`get_tracer`/`set_tracer`/
    `use_tracer`) that is a no-op when disabled;
  * `metrics` — typed registry (counters, gauges, fixed-bucket
    histograms) with a deterministic `snapshot()`;
  * `sinks`   — crash-safe streaming JSONL (`JsonlWriter`/`JsonlSink` +
    `read_jsonl`), `MemorySink` for tests, and the Chrome-trace/Perfetto
    exporter (`chrome_trace`/`write_chrome_trace`);
  * `timers`  — per-stage timing fenced by CUDA events (`timed_stage`,
    `fence`) and the kernel profiling primitive (`bench_kernel`);
  * `analysis` — `FleetAnalytics`, the streaming trace-analytics sink
    (straggler scores, occupancy/skew, byte accounting, detection
    confusion);
  * `health`  — declarative `HealthSpec` SLO probes and the
    `HealthMonitor` that turns analytics state into `health.alert`
    instants and `health.incident` spans in the same trace stream;
  * `report`  — trace-only Markdown postmortems (`postmortem_md`) and
    run-vs-run diffs (`run_diff_md`), with their command line
    (``python -m repro_torch.obs.report``).

Enabled per experiment through `api.ObsSpec`; with the spec at its
default (off) no event is constructed and no engine waits on the card —
tracing costs nothing until asked for.  `repro_torch.obs` imports nothing
from the rest of the package (and torch only inside `timers`' fences),
so every layer down to the kernels can depend on it.
"""
from .analysis import FleetAnalytics, NodeStats  # noqa: F401
from .events import (TraceEvent, Tracer, get_tracer,  # noqa: F401
                     set_tracer, use_tracer)
from .health import HealthMonitor, HealthSpec  # noqa: F401
from .metrics import (SECONDS_EDGES, STALENESS_EDGES,  # noqa: F401
                      WINDOW_SIZE_EDGES, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .sinks import (OBS_SCHEMA_VERSION, JsonlSink, JsonlWriter,  # noqa: F401
                    MemorySink, Sink, chrome_trace, read_events,
                    read_jsonl, write_chrome_trace)
from .timers import bench_kernel, fence, timed_stage  # noqa: F401


def __getattr__(name):
    # `report` loads on first use, so that ``python -m
    # repro_torch.obs.report`` does not find its own module imported
    if name in ("postmortem_md", "run_diff_md"):
        from . import report
        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
