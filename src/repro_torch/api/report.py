"""Structured, JSON-round-trippable run results.

Port of `repro.api.report` (`RoundRecord`, `RunReport`, `detection_log`):
the same record stream and the same JSON, so one spec's reports from the
two packages compare field by field.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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
