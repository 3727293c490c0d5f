"""Event sinks: in-memory, streaming JSONL, and the Chrome-trace exporter.

A copy of `repro.obs.sinks`: the same JSONL layout, torn-tail rules and
`OBS_SCHEMA_VERSION`, so each package reads the other's files.

  * `MemorySink`  — collect `TraceEvent`s in a list (tests, and the
    staging buffer the Chrome-trace export reads from);
  * `JsonlSink`   — stream events to disk as one JSON object per line,
    flushed per record, via the shared `JsonlWriter`;
  * `JsonlWriter` — the crash-safe append-per-line primitive (schema-
    stamped header line, O(1) appends, `read_jsonl` rejects or drops a
    torn final line) — also used by `api.run` to stream `RoundRecord`s
    incrementally instead of the at-end JSON dump;
  * `chrome_trace`/`write_chrome_trace` — render an event list in the
    Chrome ``trace_event`` format Perfetto loads: nodes become tracks,
    windows/stages become duration slices, arrivals/verdicts become
    instants.  Timestamps prefer the *virtual* clock (the simulation's
    arrival times) and fall back to wall time, so an async run renders
    as the timeline the paper reasons about.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional

from .events import TraceEvent

# version of the JSONL event/record stream layout (independent of the
# api's spec/report schema_version — obs is a lower layer)
OBS_SCHEMA_VERSION = 1


class Sink:
    """Interface: `emit(event)` per record, `close()` once at run end."""

    def emit(self, event: TraceEvent) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Keep every event in memory — tests and the Chrome-trace staging
    buffer."""

    def __init__(self):
        self.events: List[TraceEvent] = []

    def emit(self, event: TraceEvent) -> None:
        self.events.append(event)


# ---------------------------------------------------------------------------
# crash-safe JSONL streaming
# ---------------------------------------------------------------------------

class JsonlWriter:
    """Append-per-record JSONL file: one JSON object per line, flushed
    after every write, opened with a schema-stamped header line.

    Crash safety is the point: a process killed mid-run leaves every
    *completed* line intact and at most one torn final line, which
    `read_jsonl` detects — unlike a single JSON document, where a
    mid-write crash corrupts the whole file.
    """

    def __init__(self, path: str, header: Optional[Dict[str, Any]] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")
        h = {"kind": "header", "obs_schema": OBS_SCHEMA_VERSION}
        if header:
            h.update(header)
        self.write(h)

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_jsonl(path: str, strict: bool = True) -> List[Dict[str, Any]]:
    """Read a `JsonlWriter` stream back (header line included).

    A torn final line — the signature of a crash mid-append — raises a
    clear ValueError under ``strict=True`` (the default: silent data loss
    is worse than a loud stop) and is dropped under ``strict=False`` (how
    a resuming service would reopen its own stream).  A torn line
    *before* the end is corruption, not a crash artifact, and always
    raises.
    """
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()                     # trailing newline = clean last line
    for i, line in enumerate(lines):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                if strict:
                    raise ValueError(
                        f"{path}: truncated final JSONL line (crash "
                        f"mid-append?) — re-read with strict=False to "
                        f"drop it: {line[:80]!r}") from e
                break
            raise ValueError(f"{path}: corrupt JSONL at line {i + 1}: "
                             f"{line[:80]!r}") from e
    return out


class JsonlSink(Sink):
    """Stream `TraceEvent`s through a `JsonlWriter`."""

    def __init__(self, path: str, header: Optional[Dict[str, Any]] = None):
        self.writer = JsonlWriter(path, header=header)

    def emit(self, event: TraceEvent) -> None:
        self.writer.write(event.to_dict())

    def close(self) -> None:
        self.writer.close()


def read_events(path: str, strict: bool = True) -> List[TraceEvent]:
    """Load the `TraceEvent`s out of a `JsonlSink` stream (header and any
    non-event records skipped)."""
    return [TraceEvent.from_dict(d) for d in read_jsonl(path, strict=strict)
            if d.get("kind") in ("span", "instant", "counter")]


# ---------------------------------------------------------------------------
# Chrome trace_event / Perfetto export
# ---------------------------------------------------------------------------

_CLOUD_TRACK = "cloud"


def _track(ev: TraceEvent) -> str:
    node = ev.tags.get("node")
    return f"node {node}" if node is not None else _CLOUD_TRACK


def _ts_us(ev: TraceEvent, wall0: float) -> float:
    """Microsecond timestamp: virtual clock when stamped, else wall time
    rebased to the trace start (both end up on one comparable axis only
    when the whole stream uses one clock kind — engines stamp virt_t on
    everything simulation-side)."""
    if ev.virt_t is not None:
        return ev.virt_t * 1e6
    return (ev.wall_t - wall0) * 1e6


def chrome_trace(events: Iterable[TraceEvent]) -> Dict[str, Any]:
    """Render events as a Chrome ``trace_event`` JSON object (Perfetto and
    chrome://tracing both load it): spans -> complete ("X") slices,
    instants -> "i", counters -> "C"; one tid per node plus a cloud
    track."""
    events = list(events)
    wall0 = min((e.wall_t for e in events), default=0.0)
    tids: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []

    def tid_for(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": tids[track], "args": {"name": track}})
        return tids[track]

    tid_for(_CLOUD_TRACK)               # stable tid 1 for the cloud track
    for ev in sorted(events, key=lambda e: e.seq):
        track = _track(ev)
        tid = tid_for(track)
        ts = _ts_us(ev, wall0)
        args = {k: v for k, v in ev.tags.items()}
        if ev.kind == "span":
            dur = ((ev.virt_dur if ev.virt_dur is not None else ev.dur)
                   or 0.0) * 1e6
            out.append({"ph": "X", "name": ev.name, "pid": 1, "tid": tid,
                        "ts": ts, "dur": dur, "args": args})
        elif ev.kind == "instant":
            out.append({"ph": "i", "name": ev.name, "pid": 1, "tid": tid,
                        "ts": ts, "s": "t", "args": args})
        else:
            # counter -> a Perfetto *counter track* ("C" samples render as
            # a stepped series, not instant markers).  Counter tracks are
            # identified by (pid, name), so per-node counters get the
            # track folded into the name — each node plots as its own
            # series instead of interleaving into one garbled track.
            cname = (ev.name if track == _CLOUD_TRACK
                     else f"{ev.name} ({track})")
            out.append({"ph": "C", "name": cname, "pid": 1, "tid": tid,
                        "ts": ts, "args": {ev.name: ev.value}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs",
                          "obs_schema": OBS_SCHEMA_VERSION}}


def write_chrome_trace(path: str, events: Iterable[TraceEvent]) -> None:
    """Write the Chrome-trace JSON via temp-file rename (the export runs
    at run end — a crash must not leave a half-written trace that looks
    loadable).  One `json.dumps` (the C encoder) and one write: the same
    bytes as `json.dump`, which streams through the Python encoder."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(chrome_trace(events)))
    os.replace(tmp, path)
