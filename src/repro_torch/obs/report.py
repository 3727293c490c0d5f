"""Markdown postmortems and run-vs-run diffs from trace streams.

Both renderers take *only* the recorded JSONL rows (header + events) —
no engine internals, no live objects — so they work identically on a
live run's stream, a crash artifact re-read with ``strict=False``, or a
trace copied off another machine:

  * `postmortem_md(rows)`  — one run's story: header, fleet summary,
    incident timeline, top-k stragglers, SLO compliance (time in
    incident vs run extent), detection confusion (the Fig. 6 quality
    numbers, reconstructed from the ``detect.verdict`` audit log against
    the ``fleet.population`` ground truth), and the sim-event timeline;
  * `run_diff_md(rows_a, rows_b)` — two runs side by side: metric
    deltas with direction-aware regression verdicts (accuracy falling is
    a regression, bytes falling is an improvement).

A copy of `repro.obs.report`, with the CLI of the reference's
`tools/obs_report.py` as `main` (same subcommands, output and exit
codes):

    # one run's story: incidents, stragglers, SLO compliance, detection
    python -m repro_torch.obs.report postmortem run/events.jsonl

    # two runs side by side, non-zero exit on regression (CI gate)
    python -m repro_torch.obs.report diff base/events.jsonl \
        cand/events.jsonl --fail-on-regression
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .analysis import FleetAnalytics
from .events import TraceEvent
from .sinks import read_jsonl

_EVENT_KINDS = ("span", "instant", "counter")


def _split(rows: Iterable[Dict[str, Any]]
           ) -> Tuple[Dict[str, Any], List[TraceEvent]]:
    """Rows -> (header, events); tolerates interleaved non-event rows
    (metrics snapshots, report footers)."""
    header: Dict[str, Any] = {}
    events: List[TraceEvent] = []
    for row in rows:
        kind = row.get("kind")
        if kind == "header":
            header = row
        elif kind in _EVENT_KINDS:
            events.append(TraceEvent.from_dict(row))
    return header, events


def analyze(rows: Iterable[Dict[str, Any]]
            ) -> Tuple[Dict[str, Any], FleetAnalytics]:
    header, events = _split(rows)
    return header, FleetAnalytics.from_events(events)


# ---------------------------------------------------------------------------
# formatting primitives
# ---------------------------------------------------------------------------

def _fmt(v: Any) -> str:
    if v is None:
        return "—"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v != v:                       # NaN
            return "—"
        if abs(v) >= 1000 or (v != 0 and abs(v) < 0.01):
            return f"{v:.3g}"
        return f"{v:.3f}".rstrip("0").rstrip(".")
    return str(v)


def _fmt_bytes(v: Optional[float]) -> str:
    if v is None:
        return "—"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return (f"{v:.0f} {unit}" if unit == "B"
                    else f"{v:.2f} {unit}")
        v /= 1024
    return f"{v:.2f} GiB"


def _table(headers: List[str], rows: List[List[str]]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return out


# ---------------------------------------------------------------------------
# postmortem
# ---------------------------------------------------------------------------

def postmortem_md(rows: Iterable[Dict[str, Any]], top_k: int = 5) -> str:
    """Render one trace stream as a Markdown postmortem."""
    header, an = analyze(rows)
    snap = an.snapshot()
    lines: List[str] = ["# Fleet postmortem", ""]

    # -- run header
    meta = {k: v for k, v in header.items()
            if k not in ("kind",)} if header else {}
    if meta:
        lines += _table(["run", "value"],
                        [[k, _fmt(v)] for k, v in sorted(meta.items())])
        lines.append("")

    # -- run summary
    t0, t1 = snap["virtual_extent"]
    extent = (t1 - t0) if (t0 is not None and t1 is not None) else None
    lines += ["## Run summary", ""]
    lines += _table(["indicator", "value"], [
        ["fleet size", _fmt(snap["n_nodes"])],
        ["nodes seen", _fmt(snap["nodes_seen"])],
        ["virtual extent", f"{_fmt(extent)} s"],
        ["records (windows / rounds)",
         f"{snap['n_windows']} / {snap['n_rounds']}"],
        ["recent occupancy", _fmt(snap["occupancy_recent"])],
        ["window skew (max/median)", _fmt(snap["window_skew"])],
        ["upload bytes", _fmt_bytes(snap["total_upload_bytes"])],
        ["uploads / retransmits",
         f"{snap['total_uploads']} / {snap['total_retransmits']}"],
        ["final accuracy", _fmt(snap["final_accuracy"])],
    ])
    lines.append("")

    # -- incident timeline
    lines += ["## Incidents", ""]
    if an.incidents:
        rows_ = []
        for inc in sorted(an.incidents,
                          key=lambda i: (i.get("t") or 0.0,
                                         str(i.get("probe")))):
            subject = (f"node {inc['node']}" if "node" in inc else "fleet")
            rows_.append([
                _fmt(inc.get("t")), _fmt(inc.get("duration")),
                str(inc.get("probe")), subject, _fmt(inc.get("worst")),
                _fmt(inc.get("threshold")),
                "resolved" if inc.get("resolved") else "open at run end"])
        lines += _table(["opened (t)", "duration (s)", "probe", "subject",
                         "worst", "threshold", "state"], rows_)
    else:
        lines.append("No incidents recorded "
                     "(health probes off or nothing fired).")
    lines.append("")

    # -- SLO compliance: virtual time NOT in incident, per probe
    if an.incidents and extent and extent > 0:
        lines += ["## SLO compliance", ""]
        by_probe: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for inc in an.incidents:
            p = str(inc.get("probe"))
            by_probe[p] = by_probe.get(p, 0.0) + (inc.get("duration")
                                                  or 0.0)
            counts[p] = counts.get(p, 0) + 1
        rows_ = [[p, str(counts[p]), _fmt(by_probe[p]),
                  _fmt(max(0.0, 1.0 - by_probe[p] / extent))]
                 for p in sorted(by_probe)]
        lines += _table(["probe", "incidents", "time in incident (s)",
                         "compliance"], rows_)
        lines.append("")

    # -- top-k stragglers
    stragglers = an.top_stragglers(k=top_k)
    lines += [f"## Top {top_k} stragglers", ""]
    if stragglers:
        lines += _table(
            ["node", "score (× median gap)", "arrivals", "mean gap (s)",
             "bytes"],
            [[str(s["node"]), _fmt(s["score"]), str(s["arrivals"]),
              _fmt(s["mean_gap"]), _fmt_bytes(s["bytes"])]
             for s in stragglers])
    else:
        lines.append("No arrival cadence recorded "
                     "(sync schedule, or too few arrivals).")
    lines.append("")

    # -- detection quality (Fig. 6 reconstruction)
    det = snap["detection"]
    lines += ["## Detection quality", ""]
    if snap["n_verdicts"]:
        rows_ = [
            ["verdicts audited", str(snap["n_verdicts"])],
            ["reject rate", _fmt(snap["reject_rate"])],
            ["threshold drift", _fmt(snap["threshold_drift"])],
        ]
        if det["ground_truth"]:
            rows_ += [
                ["true positives (malicious rejected)", str(det["tp"])],
                ["false positives (honest rejected)", str(det["fp"])],
                ["true negatives (honest accepted)", str(det["tn"])],
                ["false negatives (malicious accepted)", str(det["fn"])],
                ["precision", _fmt(det["precision"])],
                ["recall", _fmt(det["recall"])],
                ["accuracy", _fmt(det["accuracy"])],
            ]
        lines += _table(["metric", "value"], rows_)
        if not det["ground_truth"]:
            lines += ["", "_No `fleet.population` ground truth in this "
                          "trace — confusion matrix unavailable._"]
    else:
        lines.append("No armed detection verdicts in this trace.")
    lines.append("")

    # -- sim-event timeline
    if an.sim_events:
        lines += ["## Simulation events", ""]
        lines += _table(
            ["t", "record", "kind"],
            [[_fmt(e.get("t")), _fmt(e.get("at_round")),
              str(e.get("kind", "?"))]
             for e in an.sim_events])
        lines.append("")

    return "\n".join(lines).rstrip() + "\n"


# ---------------------------------------------------------------------------
# run-vs-run diff
# ---------------------------------------------------------------------------

# (label, snapshot key, higher_is_better or None for neutral)
_DIFF_METRICS: List[Tuple[str, str, Optional[bool]]] = [
    ("final accuracy", "final_accuracy", True),
    ("upload bytes", "total_upload_bytes", False),
    ("uploads", "total_uploads", None),
    ("retransmits", "total_retransmits", False),
    ("reject rate", "reject_rate", None),
    ("recent occupancy", "occupancy_recent", True),
    ("window skew", "window_skew", False),
    ("windows", "n_windows", None),
    ("rounds", "n_rounds", None),
    ("verdicts", "n_verdicts", None),
    ("incidents", "n_incidents", False),
    ("alerts", "n_alerts", False),
]


def run_diff_md(rows_a: Iterable[Dict[str, Any]],
                rows_b: Iterable[Dict[str, Any]],
                label_a: str = "A", label_b: str = "B",
                rtol: float = 0.05) -> Tuple[str, int]:
    """Render a run-vs-run Markdown diff.  Returns ``(markdown,
    n_regressions)`` — a regression is a direction-aware metric moving
    the wrong way by more than ``rtol`` relative (or appearing/growing
    from zero)."""
    _, an_a = analyze(rows_a)
    _, an_b = analyze(rows_b)
    snap_a, snap_b = an_a.snapshot(), an_b.snapshot()

    rows_: List[List[str]] = []
    n_reg = 0
    for label, key, higher_better in _DIFF_METRICS:
        va, vb = snap_a.get(key), snap_b.get(key)
        verdict, is_reg = _verdict(va, vb, higher_better, rtol)
        n_reg += is_reg
        fmt = _fmt_bytes if key == "total_upload_bytes" else _fmt
        rows_.append([label, fmt(va), fmt(vb), verdict])

    det_a = snap_a["detection"]
    det_b = snap_b["detection"]
    if det_a["ground_truth"] and det_b["ground_truth"]:
        for label, key in (("detection precision", "precision"),
                           ("detection recall", "recall"),
                           ("detection accuracy", "accuracy")):
            va, vb = det_a.get(key), det_b.get(key)
            verdict, is_reg = _verdict(va, vb, True, rtol)
            n_reg += is_reg
            rows_.append([label, _fmt(va), _fmt(vb), verdict])

    lines = [f"# Run diff: {label_a} vs {label_b}", ""]
    lines += _table(["metric", label_a, label_b, "verdict"], rows_)
    lines += ["", f"**{n_reg} regression(s).**" if n_reg
              else "**No regressions.**"]
    return "\n".join(lines) + "\n", n_reg


def _verdict(va: Any, vb: Any, higher_better: Optional[bool],
             rtol: float) -> Tuple[str, bool]:
    """One metric's verdict comparing baseline ``va`` to candidate
    ``vb``."""
    if va is None and vb is None:
        return "—", False
    if va is None or vb is None:
        return "only one run", False
    va, vb = float(va), float(vb)
    if va == vb:
        return "unchanged", False
    delta = vb - va
    rel = abs(delta) / max(abs(va), abs(vb), 1e-12)
    arrow = "+" if delta > 0 else ""
    desc = f"{arrow}{_fmt(delta)} ({rel:+.1%})" if delta > 0 else \
        f"{_fmt(delta)} ({-rel:.1%})"
    if higher_better is None or rel <= rtol:
        return desc, False
    regressed = (delta < 0) if higher_better else (delta > 0)
    if regressed:
        return f"{desc} **regression**", True
    return f"{desc} improvement", False


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _load(path: str, strict: bool):
    try:
        return read_jsonl(path, strict=strict)
    except ValueError as e:
        raise SystemExit(f"obs_report: {e}\n(re-run with --tolerate-torn "
                         f"to drop a crash-torn final line)")


def _write(text: str, out):
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out}")
    else:
        print(text, end="")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Markdown postmortems and run diffs from obs trace "
                    "streams (trace-only input)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("postmortem",
                        help="render one run's Markdown postmortem")
    pm.add_argument("events", help="events JSONL from ObsSpec.events_jsonl")
    pm.add_argument("-o", "--out", default=None, help="output path "
                    "(default: stdout)")
    pm.add_argument("--top-k", type=int, default=5,
                    help="stragglers to list (default 5)")
    pm.add_argument("--tolerate-torn", action="store_true",
                    help="drop a crash-torn final JSONL line instead of "
                         "failing")

    df = sub.add_parser("diff", help="render a run-vs-run Markdown diff")
    df.add_argument("events_a", help="baseline events JSONL")
    df.add_argument("events_b", help="candidate events JSONL")
    df.add_argument("-o", "--out", default=None)
    df.add_argument("--rtol", type=float, default=0.05,
                    help="relative tolerance before a directional move "
                         "counts as a regression (default 0.05)")
    df.add_argument("--fail-on-regression", action="store_true",
                    help="exit 1 when any metric regresses (CI gate)")
    df.add_argument("--tolerate-torn", action="store_true")

    args = ap.parse_args(argv)
    strict = not args.tolerate_torn
    if args.cmd == "postmortem":
        rows = _load(args.events, strict)
        _write(postmortem_md(rows, top_k=args.top_k), args.out)
        return 0
    rows_a = _load(args.events_a, strict)
    rows_b = _load(args.events_b, strict)
    md, n_reg = run_diff_md(rows_a, rows_b,
                            label_a=os.path.basename(args.events_a),
                            label_b=os.path.basename(args.events_b),
                            rtol=args.rtol)
    _write(md, args.out)
    if n_reg and args.fail_on_regression:
        print(f"obs_report: {n_reg} regression(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
