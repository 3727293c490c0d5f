"""Streaming trace analytics: derived, windowed fleet indicators.

A copy of `repro.obs.analysis`: the same stream gives the same snapshot
in either package.

The engines, the net bridge, and the simulation service all *record*
operational signals as raw `TraceEvent`s — arrival instants, window/round
spans, per-upload ``net.upload`` accounting, the ``detect.verdict`` audit
log.  `FleetAnalytics` turns that stream into *answers*: it is a `Sink`
(attach it to a live `Tracer` and every event folds into O(nodes)
running state the moment it is emitted) and equally a post-hoc reducer
(`FleetAnalytics.from_events` replays a recorded stream), maintaining:

  * **per-node straggler scores** — each node's mean inter-arrival gap
    relative to the fleet median (score 1 = typical, k = k-times slower),
    from ``arrival`` instants;
  * **window occupancy / skew** — processed-arrival counts per window
    span against the fleet size, with a trailing deque for "recent"
    views (``round`` spans feed the same series on sync schedules);
  * **byte accounting** — cumulative and per-round/window encoded bytes
    from ``net.upload`` instants (the engines tag each commit batch with
    its round/window id);
  * **detection quality** — accept/reject totals per node, a trailing
    verdict window for drift probes, ring-threshold drift, and — when
    the runner has emitted the ``fleet.population`` ground truth — the
    full confusion matrix (Fig. 6's quality numbers) from the audit log
    alone;
  * **run annotations** — ``sim.event`` / ``sim.heartbeat`` /
    ``health.alert`` / ``health.incident`` events collected for
    postmortem timelines.

Everything is stdlib-only and deterministic: feeding the same event
stream in the same order always yields byte-identical `snapshot()`s.
`repro_torch.obs.health` evaluates live SLO probes against this state
and `repro_torch.obs.report` renders it into postmortems.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

from .events import TraceEvent
from .sinks import Sink

# trailing-window sizes for the "recent" views (fixed, like the metric
# bucket ladders: determinism beats per-run tuning)
RECENT_WINDOWS = 8
RECENT_VERDICTS = 64
RECENT_THRESHOLDS = 32


class NodeStats:
    """One node's running indicators (arrival cadence, bytes, verdicts)."""
    __slots__ = ("node", "arrivals", "first_t", "last_t", "bytes",
                 "uploads", "accepted", "rejected")

    def __init__(self, node: int):
        self.node = node
        self.arrivals = 0
        self.first_t: Optional[float] = None
        self.last_t: Optional[float] = None
        self.bytes = 0.0
        self.uploads = 0
        self.accepted = 0
        self.rejected = 0

    @property
    def mean_gap(self) -> Optional[float]:
        """Mean inter-arrival gap (needs >= 2 arrivals)."""
        if self.arrivals < 2 or self.last_t is None:
            return None
        span = self.last_t - self.first_t
        return span / (self.arrivals - 1) if span > 0 else None

    def snapshot(self) -> Dict[str, Any]:
        return {"node": self.node, "arrivals": self.arrivals,
                "mean_gap": self.mean_gap, "bytes": self.bytes,
                "uploads": self.uploads, "accepted": self.accepted,
                "rejected": self.rejected}


class FleetAnalytics(Sink):
    """Fold a `TraceEvent` stream into derived fleet indicators.

    Args:
      n_nodes: the fleet size (occupancy denominators).  Discovered from
        the first ``fleet.population`` instant when omitted.
    """

    def __init__(self, n_nodes: Optional[int] = None):
        self.n_nodes = n_nodes
        self.nodes: Dict[int, NodeStats] = {}
        self.malicious: Tuple[int, ...] = ()
        self._have_population = False
        # window/round span series: (id, t0, dur, n_processed, n_rejected)
        self.window_sizes: List[int] = []
        self.recent_windows: Deque[int] = deque(maxlen=RECENT_WINDOWS)
        self.n_windows = 0
        self.n_rounds = 0
        # bytes: cumulative + keyed by the round/window id the engines tag
        self.total_upload_bytes = 0.0
        self.total_uploads = 0
        self.total_retransmits = 0
        self.bytes_by_record: Dict[str, float] = {}
        # detection: totals, trailing verdict window, threshold drift ring
        self.n_verdicts = 0
        self.n_rejected = 0
        self.recent_verdicts: Deque[bool] = deque(maxlen=RECENT_VERDICTS)
        self.recent_thresholds: Deque[float] = deque(
            maxlen=RECENT_THRESHOLDS)
        self.confusion = {"tp": 0, "fp": 0, "tn": 0, "fn": 0}
        # annotations for the postmortem timeline
        self.sim_events: List[Dict[str, Any]] = []
        self.heartbeats: List[Dict[str, Any]] = []
        self.alerts: List[Dict[str, Any]] = []
        self.incidents: List[Dict[str, Any]] = []
        # the stream's virtual-time extent
        self.t_min: Optional[float] = None
        self.t_max: Optional[float] = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_events(cls, events: Iterable[TraceEvent],
                    n_nodes: Optional[int] = None) -> "FleetAnalytics":
        """Post-hoc reduction of a recorded stream (e.g. `read_events`)."""
        an = cls(n_nodes=n_nodes)
        for ev in events:
            an.emit(ev)
        return an

    # -- the Sink interface --------------------------------------------------
    def emit(self, event: TraceEvent) -> None:
        t = event.virt_t
        if t is not None:
            self.t_min = t if self.t_min is None else min(self.t_min, t)
            end = t + (event.virt_dur or 0.0)
            self.t_max = end if self.t_max is None else max(self.t_max, end)
        name = event.name
        if name == "arrival":
            self._on_arrival(event)
        elif name == "detect.verdict":
            self._on_verdict(event)
        elif name == "net.upload":
            self._on_upload(event)
        elif name in ("window", "round") and event.kind == "span":
            self._on_span(event)
        elif name == "fleet.population":
            self._on_population(event)
        elif name == "sim.event":
            self.sim_events.append(dict(event.tags, t=t))
        elif name == "sim.heartbeat":
            self.heartbeats.append(dict(event.tags))
        elif name == "health.alert":
            self.alerts.append(dict(event.tags, t=t))
        elif name == "health.incident":
            self.incidents.append(dict(event.tags, t=t,
                                       duration=event.virt_dur))

    # -- per-event folds -----------------------------------------------------
    def _node(self, node: int) -> NodeStats:
        st = self.nodes.get(node)
        if st is None:
            st = self.nodes[node] = NodeStats(node)
        return st

    def _on_population(self, ev: TraceEvent) -> None:
        n = ev.tags.get("n_nodes")
        if n is not None and self.n_nodes is None:
            self.n_nodes = int(n)
        self.malicious = tuple(int(m) for m in ev.tags.get("malicious", ()))
        self._have_population = True

    def _on_arrival(self, ev: TraceEvent) -> None:
        node = ev.tags.get("node")
        if node is None or ev.virt_t is None:
            return
        st = self._node(int(node))
        st.arrivals += 1
        if st.first_t is None:
            st.first_t = ev.virt_t
        st.last_t = ev.virt_t

    def _on_verdict(self, ev: TraceEvent) -> None:
        # only armed verdicts count toward detection quality: the engines
        # audit every cloud evaluation, tagging detect=False while the
        # detector is off/warming — those are observations, not verdicts
        if not ev.tags.get("detect", True):
            return
        node = ev.tags.get("node")
        rejected = bool(ev.tags.get("rejected", False))
        self.n_verdicts += 1
        self.n_rejected += rejected
        self.recent_verdicts.append(rejected)
        thr = ev.tags.get("threshold")
        if thr is not None:
            self.recent_thresholds.append(float(thr))
        if node is not None:
            st = self._node(int(node))
            if rejected:
                st.rejected += 1
            else:
                st.accepted += 1
        if self._have_population and node is not None:
            bad = int(node) in set(self.malicious)
            key = ("tp" if rejected else "fn") if bad else \
                ("fp" if rejected else "tn")
            self.confusion[key] += 1

    def _on_upload(self, ev: TraceEvent) -> None:
        node = ev.tags.get("node")
        nbytes = float(ev.tags.get("encoded_bytes", 0.0))
        self.total_upload_bytes += nbytes
        self.total_uploads += 1
        self.total_retransmits += int(ev.tags.get("retransmits", 0))
        if node is not None:
            st = self._node(int(node))
            st.bytes += nbytes
            st.uploads += 1
        for key in ("round", "window"):
            rid = ev.tags.get(key)
            if rid is not None:
                k = f"{key}:{int(rid)}"
                self.bytes_by_record[k] = \
                    self.bytes_by_record.get(k, 0.0) + nbytes
                break

    def _on_span(self, ev: TraceEvent) -> None:
        tags = ev.tags
        if ev.name == "round":
            self.n_rounds += 1
            size = tags.get("n_participating")
        else:
            self.n_windows += 1
            size = tags.get("n_processed")
        if size is not None:
            self.window_sizes.append(int(size))
            self.recent_windows.append(int(size))

    # -- derived indicators --------------------------------------------------
    def straggler_scores(self, min_arrivals: int = 2) -> Dict[int, float]:
        """node -> inter-arrival gap / fleet median gap.  A node at score
        k arrives k-times slower than the typical node.

        Nodes with a real cadence (>= 2 arrivals) use their mean
        inter-arrival gap; nodes the stream has barely seen use the run
        extent over their arrival count — a *lower bound* on their true
        gap, which is exactly the straggler signature in a fixed-arrival-
        budget run (the slow tail shows up as absence, not as long
        measured gaps).  Nothing is scored until the fleet-median node
        has >= ``min_arrivals`` arrivals (a cold fleet has no baseline
        cadence)."""
        if self.t_min is None or self.t_max is None:
            return {}
        extent = self.t_max - self.t_min
        if extent <= 0:
            return {}
        n_ids = self.n_nodes or (max(self.nodes) + 1 if self.nodes else 0)
        gaps: Dict[int, float] = {}
        counts: List[int] = []
        for n in range(n_ids):
            st = self.nodes.get(n)
            arr = st.arrivals if st is not None else 0
            counts.append(arr)
            mg = st.mean_gap if st is not None else None
            gaps[n] = (mg if arr >= 2 and mg is not None
                       else extent / max(1, arr))
        if not counts or _median(sorted(counts)) < max(2, min_arrivals):
            return {}
        med = _median(sorted(gaps.values()))
        if med <= 0:
            return {}
        return {n: g / med for n, g in sorted(gaps.items())}

    def top_stragglers(self, k: int = 5,
                       min_arrivals: int = 2) -> List[Dict[str, Any]]:
        scores = self.straggler_scores(min_arrivals)
        top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [dict((self.nodes[n] if n in self.nodes
                      else NodeStats(n)).snapshot(), score=s)
                for n, s in top]

    def recent_occupancy(self) -> Optional[float]:
        """Mean processed-arrival count over the trailing windows, as a
        fraction of the fleet (None until a span has landed or the fleet
        size is unknown)."""
        if not self.recent_windows or not self.n_nodes:
            return None
        return (sum(self.recent_windows)
                / len(self.recent_windows) / self.n_nodes)

    def window_skew(self) -> Optional[float]:
        """max/median window size over the trailing windows — 1 means
        even composition, large values mean a few windows swallow the
        fleet (the straggler/flash-crowd signature)."""
        if not self.recent_windows:
            return None
        med = _median(sorted(self.recent_windows))
        return max(self.recent_windows) / med if med > 0 else None

    def recent_reject_rate(self, window: int) -> Optional[float]:
        """Rejected fraction of the trailing ``window`` verdicts (None
        until that many verdicts have been audited)."""
        if window < 1 or len(self.recent_verdicts) < window:
            return None
        tail = list(self.recent_verdicts)[-window:]
        return sum(tail) / window

    def reject_rate(self) -> Optional[float]:
        return (self.n_rejected / self.n_verdicts if self.n_verdicts
                else None)

    def threshold_drift(self) -> Optional[float]:
        """Detection ring-threshold drift: last threshold minus the
        median of the trailing ring (the percentile gate shifting under
        an attack or accuracy regime change)."""
        if len(self.recent_thresholds) < 2:
            return None
        ring = sorted(self.recent_thresholds)
        return self.recent_thresholds[-1] - _median(ring)

    def detection_quality(self) -> Dict[str, Any]:
        """Confusion counts + precision/recall/accuracy against the
        ``fleet.population`` ground truth (zeros when never emitted)."""
        c = dict(self.confusion)
        tp, fp, tn, fn = c["tp"], c["fp"], c["tn"], c["fn"]
        total = tp + fp + tn + fn
        c["precision"] = tp / (tp + fp) if tp + fp else None
        c["recall"] = tp / (tp + fn) if tp + fn else None
        c["accuracy"] = (tp + tn) / total if total else None
        c["ground_truth"] = self._have_population
        return c

    def final_accuracy(self) -> Optional[float]:
        if self.heartbeats:
            return self.heartbeats[-1].get("accuracy")
        return None

    def snapshot(self) -> Dict[str, Any]:
        """Every indicator as one deterministic JSON-ready dict (the
        report/diff surface)."""
        sizes = sorted(self.window_sizes)
        return {
            "n_nodes": self.n_nodes,
            "nodes_seen": len(self.nodes),
            "virtual_extent": [self.t_min, self.t_max],
            "n_windows": self.n_windows,
            "n_rounds": self.n_rounds,
            "occupancy_recent": self.recent_occupancy(),
            "window_skew": self.window_skew(),
            "window_size_median": _median(sizes) if sizes else None,
            "total_upload_bytes": self.total_upload_bytes,
            "total_uploads": self.total_uploads,
            "total_retransmits": self.total_retransmits,
            "bytes_by_record": dict(sorted(self.bytes_by_record.items())),
            "n_verdicts": self.n_verdicts,
            "n_rejected": self.n_rejected,
            "reject_rate": self.reject_rate(),
            "threshold_drift": self.threshold_drift(),
            "detection": self.detection_quality(),
            "straggler_scores": {str(n): s for n, s in
                                 self.straggler_scores().items()},
            "final_accuracy": self.final_accuracy(),
            "n_sim_events": len(self.sim_events),
            "n_alerts": len(self.alerts),
            "n_incidents": len(self.incidents),
        }


def _median(sorted_vals: List[float]) -> float:
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return float(sorted_vals[mid])
    return (sorted_vals[mid - 1] + sorted_vals[mid]) / 2.0
