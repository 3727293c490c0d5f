"""Typed metrics registry: counters, gauges, histograms with fixed buckets.

A copy of `repro.obs.metrics`: the same snapshots and Prometheus text.

Aggregated (as opposed to per-event) observability: upload counts, encoded
vs analytic byte totals, window sizes and staleness, detection verdicts,
retransmits/loss from the link model.  Three metric types:

  * `Counter`   — monotone accumulator (`inc`);
  * `Gauge`     — last-written value (`set`);
  * `Histogram` — counts over **fixed, caller-declared bucket edges** so
    two runs of the same spec produce byte-identical snapshots (no
    dynamic rebinning — determinism is part of the contract, the same
    discipline as the fixed detection ring).

`MetricsRegistry.snapshot()` reduces everything to one sorted, JSON-ready
dict; `Tracer` owns a registry (`tracer.metrics`) so instrumented layers
share a single handle, but the registry is independently constructible
for tests.  Stdlib-only, like the rest of `repro_torch.obs`.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotone accumulator.  ``inc`` by any non-negative amount."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"Counter {self.name!r} is monotone; "
                             f"inc({amount}) would decrease it")
        self.value += float(amount)

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (window size, ring occupancy, current version)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram.

    ``edges`` are the finite upper bounds; observations land in the first
    bucket whose edge is >= the value, with one implicit +inf overflow
    bucket.  Edges are frozen at construction — re-requesting the same
    histogram with different edges is an error (silently merging two
    binnings would make snapshots meaningless).
    """
    __slots__ = ("name", "edges", "counts", "total", "sum", "min", "max")

    def __init__(self, name: str, edges: Sequence[float]):
        e = tuple(float(x) for x in edges)
        if not e or any(b <= a for a, b in zip(e, e[1:])):
            raise ValueError(f"Histogram {name!r} needs strictly increasing "
                             f"non-empty bucket edges, got {edges}")
        self.name = name
        self.edges = e
        self.counts = [0] * (len(e) + 1)    # +1: the +inf overflow bucket
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.total += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile by linear interpolation inside the
        bucket the target rank lands in.

        Bucket i spans ``(edges[i-1], edges[i]]``; the first bucket's
        lower bound and the overflow bucket's upper bound are the
        *observed* min/max (tracked per histogram), so the estimate is
        always inside the observed range — tighter than the Prometheus
        convention of clamping to the outermost edge.  Returns None on an
        empty histogram.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        if self.total == 0:
            return None
        target = q * self.total
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else self.min
                hi = (self.edges[i] if i < len(self.edges) else self.max)
                frac = (target - cum) / c if c else 0.0
                v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return float(min(max(v, self.min), self.max))
            cum += c
        return float(self.max)

    def snapshot(self) -> Dict:
        return {"type": "histogram", "edges": list(self.edges),
                "counts": list(self.counts), "count": self.total,
                "sum": self.sum, "min": self.min, "max": self.max}


class MetricsRegistry:
    """Name -> metric, created on first touch, type-checked on re-touch."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"requested as {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, edges: Sequence[float]) -> Histogram:
        h = self._get(name, Histogram, edges)
        if h.edges != tuple(float(x) for x in edges):
            raise ValueError(f"histogram {name!r} already registered with "
                             f"edges {h.edges}, re-requested with {edges}")
        return h

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict]:
        """Deterministic (sorted-key) dump of every metric — what the obs
        session appends to the event JSONL at run end."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def to_prom_text(self) -> str:
        """The registry as Prometheus text exposition (version 0.0.4):
        ``# TYPE`` line per metric, cumulative ``_bucket{le=...}`` series
        plus ``_sum``/``_count`` for histograms.  Metric names are
        sanitized to the Prometheus charset (dots become underscores), so
        a snapshot served or dumped this way is scrapeable as-is."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_prom_float(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_float(m.value)}")
            else:                       # Histogram: cumulative buckets
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for edge, c in zip(m.edges, m.counts):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{_prom_float(edge)}"}}'
                                 f" {cum}")
                cum += m.counts[-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_prom_float(m.sum)}")
                lines.append(f"{pname}_count {m.total}")
        return "\n".join(lines) + ("\n" if lines else "")


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_float(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# Shared bucket ladders: powers-of-two style edges the engines use so
# window-size / staleness / transfer-time histograms are comparable across
# runs and benchmarks without per-run tuning.
WINDOW_SIZE_EDGES: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)
STALENESS_EDGES: Tuple[float, ...] = (0, 1, 2, 4, 8, 16, 32, 64, 128)
SECONDS_EDGES: Tuple[float, ...] = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
    100.0, 300.0, 1000.0)
