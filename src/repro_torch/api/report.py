"""Structured, JSON-round-trippable run results.

Port of `repro.api.report` (`RoundRecord`, `RunReport`, `detection_log`,
the ``results/*.json`` trajectory writer and the streamed-record replay):
the same record stream and the same JSON, so one spec's reports from the
two packages compare field by field.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.async_update import communication_efficiency
from ..obs import read_jsonl
from .spec import ACCEPTED_SCHEMA_VERSIONS, SCHEMA_VERSION


@dataclass
class RoundRecord:
    """One row of every trajectory: the per-round (sync) / per-n_nodes-
    arrivals (async) record stream all execution paths emit."""
    t: float
    version: int
    accuracy: float
    comm_bytes: float
    comp_time: float
    comm_time: float
    n_rejected: int
    # how comm_bytes was produced: "analytic" (the closed-form values +
    # indices estimate) or "encoded" (repro.net wire-codec byte counts) —
    # keeps mixed trajectories in results/*.json interpretable
    bytes_source: str = "analytic"


@dataclass
class RunReport:
    """The structured result of `run.run`.

    ``final_params`` is execution-side state (a dict of tensors) — available on
    fresh reports for follow-on evaluation, never serialized, and None
    after a JSON round trip.
    """
    mode: str                           # sync | async
    engine: str                         # sequential | fleet | fleet-mesh
    records: List[RoundRecord] = field(default_factory=list)
    kappa: float = 0.0                  # Eq. (5) over the whole run
    epsilon_spent: float = 0.0          # 0 exactly for no-noise runs
    final_accuracy: float = 0.0
    detections: List[Dict] = field(default_factory=list)
    spec: Optional[Dict] = None         # ExperimentSpec.to_dict(), if known
    net: Optional[Dict] = None          # repro.net NetTrace summary (wire
                                        # codec + encoded/wire byte totals)
                                        # when the network subsystem ran
    # v5 resume metadata: set when the run was restored from a checkpoint
    # (repro.sim); None for uninterrupted runs and pre-v5 payloads
    resumed_from: Optional[str] = None  # checkpoint base path
    resume_round: Optional[int] = None  # record index the run resumed at
    schema_version: int = SCHEMA_VERSION
    final_params: Any = field(default=None, repr=False, compare=False)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "schema_version": self.schema_version,
            "mode": self.mode,
            "engine": self.engine,
            "records": [dataclasses.asdict(r) for r in self.records],
            "kappa": self.kappa,
            "epsilon_spent": self.epsilon_spent,
            "final_accuracy": self.final_accuracy,
            "detections": self.detections,
            "spec": self.spec,
            "net": self.net,
            "resumed_from": self.resumed_from,
            "resume_round": self.resume_round,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict) -> "RunReport":
        version = d.get("schema_version")
        if version not in ACCEPTED_SCHEMA_VERSIONS:
            raise ValueError(f"RunReport schema_version {version!r} not in "
                             f"supported {ACCEPTED_SCHEMA_VERSIONS}")
        # v1 records predate bytes_source — RoundRecord defaults it to
        # "analytic", which is what every v1 trajectory actually was
        return cls(mode=d["mode"], engine=d["engine"],
                   records=[RoundRecord(**r) for r in d["records"]],
                   kappa=d["kappa"], epsilon_spent=d["epsilon_spent"],
                   final_accuracy=d["final_accuracy"],
                   detections=list(d.get("detections", [])),
                   spec=d.get("spec"), net=d.get("net"),
                   # pre-v5 payloads have no resume metadata — uninterrupted
                   resumed_from=d.get("resumed_from"),
                   resume_round=d.get("resume_round"),
                   schema_version=SCHEMA_VERSION)

    @classmethod
    def from_json(cls, s: str) -> "RunReport":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))

    @classmethod
    def load(cls, path: str) -> "RunReport":
        with open(path) as f:
            return cls.from_json(f.read())


def detection_log(records: List[RoundRecord]) -> List[Dict]:
    """The rounds where the cloud rejected updates (Alg. 2 firing)."""
    return [{"round": i, "t": r.t, "n_rejected": r.n_rejected}
            for i, r in enumerate(records) if r.n_rejected]


def append_json_records(path: str, records: List[Dict]) -> None:
    """Append schema-stamped result records to a JSON trajectory file —
    the one write path for ``results/*.json`` (benchmarks route through
    this instead of hand-rolling their own schemas)."""
    if not records:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    traj = []
    if os.path.exists(path):
        with open(path) as f:
            traj = json.load(f)
        if not isinstance(traj, list):
            raise ValueError(
                f"append_json_records: {path} holds a JSON "
                f"{type(traj).__name__}, not a trajectory list — single "
                f"RunReports written by RunReport.save live in their own "
                f"files")
    for rec in records:
        stamped = dict(rec)
        stamped.setdefault("schema_version", SCHEMA_VERSION)
        traj.append(stamped)
    # write-then-rename: a crash mid-dump must never replace a valid
    # trajectory with a torn one (the old file survives intact)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(traj, f, indent=1)
    os.replace(tmp, path)


def load_json_records(path: str) -> List[Dict]:
    """Read an `append_json_records` trajectory back, validating shape."""
    with open(path) as f:
        traj = json.load(f)
    if not isinstance(traj, list):
        raise ValueError(f"load_json_records: {path} holds a JSON "
                         f"{type(traj).__name__}, not a trajectory list")
    return traj


# ---------------------------------------------------------------------------
# streamed-record replay (the ObsSpec.records_jsonl stream)
# ---------------------------------------------------------------------------

def replay_records(path: str, strict: bool = True) -> RunReport:
    """Rebuild a `RunReport` from an ``obs.records_jsonl`` stream.

    The stream is header / one line per `RoundRecord` / a final ``report``
    footer.  Derived quantities (κ, final accuracy, the detection log) are
    recomputed from the replayed records — for a complete stream the
    result equals the in-memory report exactly; for a crashed stream
    (``strict=False`` drops a torn tail, the footer may be missing) it is
    the faithful report of every round that completed.
    """
    rows = read_jsonl(path, strict=strict)
    header = rows[0] if rows and rows[0].get("kind") == "header" else {}
    records = [RoundRecord(**{k: v for k, v in r.items() if k != "kind"})
               for r in rows if r.get("kind") == "record"]
    footer = next((r for r in reversed(rows)
                   if r.get("kind") == "report"), None)
    meta = dict(footer) if footer is not None else dict(header)
    comm = sum(r.comm_time for r in records)
    comp = sum(r.comp_time for r in records)
    return RunReport(
        mode=meta["mode"], engine=meta["engine"], records=records,
        kappa=communication_efficiency(comm, comp),
        epsilon_spent=meta.get("epsilon_spent", 0.0),
        final_accuracy=records[-1].accuracy if records else 0.0,
        detections=detection_log(records),
        spec=meta.get("spec"), net=meta.get("net"))
