"""Declarative experiment specs — a copy of `repro.api.spec` (schema v6).

The same spec JSON loads in both packages and round-trips unchanged.

The paper's framework is one system with four composable axes — schedule
(sync/async/buffered), privacy (ALDP), communication (DGC sparsify) and
defense (cloud-side detection) — plus a population and a placement.  An
`ExperimentSpec` states each axis once:

  * `FleetSpec`      — population: size, per-node heterogeneity
                       (`NodeHeterogeneity`), attack mix (`AttackMix`),
                       availability/cohort sampling, synthetic-data shape;
  * `SchedulePolicy` — sync | async | buffered, Eq. (6) α, staleness
                       weighting, and a pluggable `WindowPolicy`;
  * `PrivacySpec`    — ALDP noise multiplier (explicit, calibrated from
                       (ε, δ), or off);
  * `CompressionSpec`— DGC sparsified uploads;
  * `DefenseSpec`    — Alg. 2 detection threshold/warmup/window;
  * `NetworkSpec`    — `repro.net` wire codecs + virtual-time link
                       simulation (default: the analytic comm model);
  * `Topology`       — sequential reference loop | single-device fleet
                       engines | node-axis `FleetMesh` sharding;
  * `TrainSpec`      — node-local SGD hyperparameters;
  * `SimSpec`        — optional always-on-service axis: time-varying
                       `TrafficTrace`s, a `SimEvent` mutation timeline and
                       a checkpoint cadence (executed by `repro.sim`).

`plan.compile_plan` validates cross-field constraints once and lowers a
spec to an `ExperimentPlan`; `run.run` executes a plan.  Specs are plain
frozen dataclasses and JSON-round-trippable (`to_dict`/`from_dict`, with a
``schema_version`` field) so experiment definitions can live in files
instead of flag soup.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..obs.health import HealthSpec
from .window import AutoWindow, WindowPolicy, window_policy_from_dict

# v2: NetworkSpec axis + RoundRecord.bytes_source.  v3: ObsSpec axis.
# v4: the adversary zoo (AttackMix.kind + per-kind knobs, seeded-random
# malicious placement, FleetSpec.n_classes) and the trust-scored defense
# (DefenseSpec.kind + trust knobs).  v5: the simulation-service axis
# (ExperimentSpec.sim: traffic traces + event timeline + checkpoint
# cadence) and RunReport resume metadata.  v6: the fleet-health axis
# (ObsSpec.health: HealthSpec SLO probes + incident detection).  Older
# payloads are still accepted on read (health defaults to None — no
# probes); everything written is stamped v6.
SCHEMA_VERSION = 6
ACCEPTED_SCHEMA_VERSIONS = (1, 2, 3, 4, 5, 6)


# ---------------------------------------------------------------------------
# population
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeHeterogeneity:
    """Per-node system model: lognormal compute speeds around
    ``base_compute_s`` plus an optional straggler tail, uniform uplink
    bandwidth (matches `fleet.NodeProfile.lognormal`)."""
    base_compute_s: float = 1.0
    heterogeneity: float = 0.5          # lognormal sigma of node speeds
    bandwidth_bps: float = 12.5e6       # 100 Mbit/s edge uplink
    straggler_frac: float = 0.0
    straggler_slowdown: float = 10.0


@dataclass(frozen=True)
class AttackMix:
    """Adversary composition: ``malicious_frac`` of nodes run the attack
    selected by ``kind`` (the adversary zoo).

    ``kind="label_flip"`` — the paper's poisoning attack: flip labels
      ``flip_src`` -> ``flip_dst`` in the malicious nodes' local shards;
    ``kind="sybil"``      — colluding clones: every sybil trains the same
      flipped shard on an identical compute cadence (so their uploads land
      inside one async arrival window) and scales its poisoned delta by
      ``sybil_boost``;
    ``kind="backdoor"``   — trigger poisoning: ``trigger_frac`` of each
      malicious shard gets a ``trigger_size``² corner patch of
      ``trigger_value`` and label ``trigger_label`` (clean-label accuracy
      stays high — percentile detection is nearly blind to it);
    ``kind="adaptive"``   — detection-aware label flipper: a per-node
      throttle scales the poisoned delta down by ``adapt_poison_scale``
      whenever the cloud rejects the node, creeping back up on acceptance
      — hovering under the accuracy threshold;
    ``kind="ddos"``       — clean-data flash traffic: each malicious node
      injects ``ddos_uploads`` flood uploads per round/window into the
      shared uplink (`NetworkSpec.shared_uplink_bps`), starving honest
      transfers without ever uploading a detectable model.

    ``placement`` places the malicious ids: ``"random"`` draws them from a
    seeded stream (reproducible per spec seed); ``"first"`` keeps the
    legacy nodes ``0..k-1`` placement.
    """
    malicious_frac: float = 0.0
    flip_src: int = 1
    flip_dst: int = 7
    kind: str = "label_flip"
    sybil_boost: float = 3.0
    adapt_poison_scale: float = 0.5
    trigger_frac: float = 0.5
    trigger_label: int = 0
    trigger_size: int = 2
    trigger_value: float = 1.0
    ddos_uploads: int = 4
    placement: str = "random"


@dataclass(frozen=True)
class FleetSpec:
    """The node population and its synthetic federated dataset."""
    n_nodes: int = 10
    profile: NodeHeterogeneity = field(default_factory=NodeHeterogeneity)
    attack: AttackMix = field(default_factory=AttackMix)
    availability: float = 1.0       # per-round P(node reachable); <1 => churn
    cohort_frac: float = 1.0        # uniform 'm of K' sampling; <1 => sampled
    # synthetic data shape (materialized by `population.materialize`)
    model: str = "mlp"              # mlp | cnn
    hw: Tuple[int, int] = (8, 8)
    samples_per_node: int = 60
    n_test: int = 256
    n_cloud_test: int = 128
    iid: bool = True                # False => Dirichlet(alpha) partition
    dirichlet_alpha: float = 0.5
    n_classes: int = 10             # label alphabet (bounds flip/trigger ids)


# ---------------------------------------------------------------------------
# the four framework axes + placement
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SchedulePolicy:
    """When updates meet the global model.

    ``kind="sync"``     — FedAvg barrier rounds;
    ``kind="async"``    — Eq. (6) α-mix per arrival, in arrival order;
    ``kind="buffered"`` — FedBuff-style: one masked-mean Eq. (6) mix per
                          arrival window (pairs naturally with a
                          load-aware `WindowPolicy`).

    ``staleness_adaptive`` applies the FedAsync (τ+1)^-``staleness_a``
    discount: per arrival for ``kind="async"`` (`mix_stale`), and as
    per-update weights inside the buffered mean for ``kind="buffered"``
    (uniform weights ≡ the plain masked mean).
    """
    kind: str = "sync"
    alpha: float = 0.5                  # Eq. (6) mixing weight
    staleness_adaptive: bool = False    # FedAsync (τ+1)^-a weighting
    staleness_a: float = 0.5
    window: WindowPolicy = field(default_factory=AutoWindow)


@dataclass(frozen=True)
class PrivacySpec:
    """ALDP (§5.2): ``sigma=0`` disables noise (and the accountant);
    ``sigma=None`` calibrates the multiplier from (ε, δ) per Definition 2;
    an explicit ``sigma>0`` is used as-is."""
    sigma: Optional[float] = 0.0
    epsilon: float = 8.0
    delta: float = 1e-3
    clip_s: float = 1.0


@dataclass(frozen=True)
class CompressionSpec:
    """DGC gradient-accumulation uploads (§5.1): keep the top
    ``sparsify_ratio`` of delta magnitude, accumulate the rest locally."""
    sparsify_ratio: float = 1.0


@dataclass(frozen=True)
class DefenseSpec:
    """Cloud-side malicious-update detection (§5.4, Alg. 2).

    ``kind="percentile"`` keeps the paper's accuracy-percentile accept/
    reject gate.  ``kind="trust_weighted"`` layers per-node trust scores
    on top: each verdict moves a node's trust by an EWMA
    (``trust_eta``), and accepted updates are aggregated with
    trust/uncertainty weights — trust floored at ``trust_floor`` and
    discounted by ``uncertainty_scale`` × the node's accuracy deviation
    from the accepted cohort mean (a cheap per-update uncertainty
    proxy).  Requires ``detect=True``; trust state lives device-side in
    `FleetState.trust` (ring-compatible, shard-oblivious).
    """
    detect: bool = False
    detect_s: float = 80.0              # top-s percentile threshold
    detect_warmup: int = 4              # async: min arrivals before detecting
    detect_window: Optional[int] = None  # async ring; None => default_window
    kind: str = "percentile"            # percentile | trust_weighted
    trust_eta: float = 0.25             # EWMA step toward each verdict
    trust_floor: float = 0.05           # min aggregation weight for accepted
    uncertainty_scale: float = 4.0      # accuracy-deviation discount strength


@dataclass(frozen=True)
class NetworkSpec:
    """The `repro.net` transport layer: wire codec + link simulation.

    ``codec="analytic"`` (default) keeps the pre-net behaviour — upload
    bytes estimated by the shared analytic formula, per-node transfer
    times fixed at bytes/bandwidth — so existing trajectories are
    untouched.  Any real codec turns on byte-accurate accounting (every
    upload's measured nonzero count priced through the codec, summed into
    `RunReport.net` and the records' ``comm_bytes``) and the stochastic
    link model (per-node lognormal bandwidth scales, fixed latency,
    exponential jitter, MTU-packetized loss/retransmits, optional
    shared-uplink contention), which drives the async engines' node
    clocks — arrival order and window composition respond to the network.
    """
    codec: str = "analytic"         # analytic | dense_f32 | sparse_coo
                                    # | sparse_bitpack
    value_bits: int = 32            # 8|16: sparse_bitpack quantized values
    bandwidth_sigma: float = 0.0    # lognormal sigma of per-node uplink scale
    latency_s: float = 0.0          # fixed per-upload propagation latency
    jitter_s: float = 0.0           # exponential per-upload jitter scale
    loss_prob: float = 0.0          # per-packet loss probability
    mtu_bytes: int = 1500           # packet size for the loss model
    shared_uplink_bps: float = 0.0  # >0: uplink shared by concurrent uploads

    @property
    def enabled(self) -> bool:
        return self.codec != "analytic"


@dataclass(frozen=True)
class ObsSpec:
    """The `repro.obs` observability layer for one run.

    Default (disabled) is a strict no-op: no tracer is installed, no event
    is constructed, and the engines' jitted programs are byte-identical to
    an obs-less build — enabling observability is free until asked for,
    and asking for it never changes simulation results (only, with
    ``stage_timings``, host-side pipelining).

      * ``events_jsonl``  — stream every `TraceEvent` (window spans,
        arrival instants, detection verdicts, per-upload link events) to
        this path as crash-safe JSONL, plus a final metrics snapshot;
      * ``chrome_trace``  — write the run's events as Chrome
        ``trace_event`` JSON (Perfetto-loadable: nodes as tracks, windows
        as spans, arrivals as instants);
      * ``records_jsonl`` — stream each `RoundRecord` to this path as it
        is produced (instead of only the at-end `RunReport` dump); the
        stream replays back into the exact final report
        (`report.replay_records`);
      * ``stage_timings`` — `block_until_ready`-fenced spans around each
        host pipeline stage (build/device program/net draw+commit/eval).
        Off by default even when tracing: fencing serializes JAX's async
        dispatch, an intentional measurement-mode perf change;
      * ``health``        — optional `repro.obs.HealthSpec`: declarative
        SLO probes (straggler factor, per-record byte budget, detection
        reject-rate ceiling, occupancy floor) evaluated between records,
        emitting ``health.alert`` instants and ``health.incident`` spans
        into the same trace stream.  Requires ``enabled=True``; probes
        only *read* derived analytics and *write* events, so the
        simulation trajectory is untouched.
    """
    enabled: bool = False
    events_jsonl: Optional[str] = None
    chrome_trace: Optional[str] = None
    records_jsonl: Optional[str] = None
    stage_timings: bool = False
    health: Optional[HealthSpec] = None


@dataclass(frozen=True)
class Topology:
    """Where the simulation runs.

    ``kind="sequential"`` — the per-node/per-arrival reference loops
    (the seed implementation; slow, bit-exact ground truth);
    ``kind="single"``     — the cohort/window-batched fleet engines on one
    device; ``kind="mesh"`` — node axis sharded over ``devices`` ranks
    of the default `torch.distributed` group via `fleet.FleetMesh`
    (None = its world size).
    """
    kind: str = "single"
    devices: Optional[int] = None
    backend: str = "reference"          # reference | pallas upload pipeline


@dataclass(frozen=True)
class TrainSpec:
    """Node-local minibatch SGD."""
    local_steps: int = 5
    batch_size: int = 16
    lr: float = 0.1


# ---------------------------------------------------------------------------
# the simulation-service axis (repro.sim)
# ---------------------------------------------------------------------------

TRACE_KINDS = ("diurnal", "flash_crowd", "outage")
SIM_EVENT_KINDS = ("attack", "defense", "network", "nodes")


@dataclass(frozen=True)
class TrafficTrace:
    """One time-varying traffic component, a pure function of virtual time.

    ``kind="diurnal"``     — fleet-wide sinusoidal bandwidth modulation:
      every node's effective uplink rate is scaled by
      ``1 - amplitude * (0.5 + 0.5 * sin(2π (t - phase_s) / period_s))``
      (peak load = deepest throttle);
    ``kind="flash_crowd"`` — during ``[t_start, t_start + duration_s)`` a
      contiguous regional block of ``node_frac`` of the fleet (starting at
      node ``floor(region_start * n)``, wrapping) has its uplink scaled by
      ``1 - amplitude`` (a crowd saturating the regional backhaul);
    ``kind="outage"``      — the same regional block is unreachable for
      the epoch: its nodes drop out of sync cohorts and their async
      arrivals are discarded/redispatched by the churn sampler.

    Traces compose multiplicatively (bandwidth) / conjunctively
    (availability), and being pure in ``t`` they are resume-safe by
    construction.
    """
    kind: str = "diurnal"
    period_s: float = 86400.0
    amplitude: float = 0.5
    phase_s: float = 0.0
    t_start: float = 0.0
    duration_s: float = 0.0
    node_frac: float = 1.0
    region_start: float = 0.0


@dataclass(frozen=True)
class SimEvent:
    """A scheduled mid-run mutation, applied between rounds/windows.

    ``at_round`` is the record index (sync round or async window-group)
    *before* which the event fires.  ``kind`` picks the spec slice:

      * ``"attack"``  — replace `AttackMix` fields (e.g. attack onset:
        ``{"malicious_frac": 0.5, "kind": "label_flip"}``; offset:
        ``{"malicious_frac": 0.0}``);
      * ``"defense"`` — replace `DefenseSpec` fields (defense toggles);
      * ``"network"`` — replace `NetworkSpec` fields (link-regime shifts);
      * ``"nodes"``   — membership churn: ``{"leave": [ids], "join":
        [ids]}`` (joins re-admit previously-left nodes).

    Payloads for the spec-slice kinds are re-validated by `compile_plan`
    at submission time: every cumulative mutation along the timeline must
    itself compile.
    """
    at_round: int = 1
    kind: str = "attack"
    payload: Dict = field(default_factory=dict)


@dataclass(frozen=True)
class SimSpec:
    """The always-on simulation service axis.

    Attaching a `SimSpec` routes `api.run` through `repro.sim.SimService`:
    the run becomes steppable, checkpoint/resumable (bit-exact), traffic-
    modulated (``traces``) and mutable mid-run (``events``).  The empty
    default mutates nothing — the service then reproduces the batch run
    exactly.
    """
    traces: Tuple[TrafficTrace, ...] = ()
    events: Tuple[SimEvent, ...] = ()
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0       # checkpoint every k records; 0 = manual


def apply_sim_event(spec: "ExperimentSpec", event: SimEvent) -> "ExperimentSpec":
    """The spec produced by one timeline event (pure; ``nodes`` events are
    membership-level and leave the spec untouched)."""
    payload = dict(event.payload)
    if event.kind == "attack":
        attack = dataclasses.replace(spec.fleet.attack, **payload)
        return dataclasses.replace(
            spec, fleet=dataclasses.replace(spec.fleet, attack=attack))
    if event.kind == "defense":
        return dataclasses.replace(
            spec, defense=dataclasses.replace(spec.defense, **payload))
    if event.kind == "network":
        return dataclasses.replace(
            spec, network=dataclasses.replace(spec.network, **payload))
    if event.kind == "nodes":
        return spec
    raise ValueError(f"unknown SimEvent kind {event.kind!r} "
                     f"(expected one of {SIM_EVENT_KINDS})")


# ---------------------------------------------------------------------------
# the whole experiment
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExperimentSpec:
    fleet: FleetSpec = field(default_factory=FleetSpec)
    schedule: SchedulePolicy = field(default_factory=SchedulePolicy)
    privacy: PrivacySpec = field(default_factory=PrivacySpec)
    compression: CompressionSpec = field(default_factory=CompressionSpec)
    defense: DefenseSpec = field(default_factory=DefenseSpec)
    network: NetworkSpec = field(default_factory=NetworkSpec)
    obs: ObsSpec = field(default_factory=ObsSpec)
    topology: Topology = field(default_factory=Topology)
    train: TrainSpec = field(default_factory=TrainSpec)
    sim: Optional[SimSpec] = None   # None => plain batch run
    rounds: int = 10        # sync rounds; async runs rounds*n_nodes arrivals
    seed: int = 0

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict:
        d = {"schema_version": SCHEMA_VERSION}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, WindowPolicy):
                v = v.to_dict()
            elif dataclasses.is_dataclass(v):
                v = _section_to_dict(v)
            d[f.name] = v
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExperimentSpec":
        d = dict(d)
        version = d.pop("schema_version", None)
        if version not in ACCEPTED_SCHEMA_VERSIONS:
            raise ValueError(
                f"ExperimentSpec schema_version {version!r} not in "
                f"supported {ACCEPTED_SCHEMA_VERSIONS}")
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name == "fleet":
                v = _fleet_from_dict(v)
            elif f.name == "schedule":
                v = _schedule_from_dict(v)
            elif f.name == "sim":
                v = _sim_from_dict(v)
            elif f.name == "obs":
                v = _obs_from_dict(v)
            elif f.name in _SECTION_TYPES:
                v = _SECTION_TYPES[f.name](**v)
            kw[f.name] = v
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))


_SECTION_TYPES = {
    "privacy": PrivacySpec,
    "compression": CompressionSpec,
    "defense": DefenseSpec,
    "network": NetworkSpec,
    "obs": ObsSpec,
    "topology": Topology,
    "train": TrainSpec,
}


def _section_to_dict(v) -> Dict:
    """dataclasses.asdict, but tuples stay JSON-friendly lists and nested
    dataclasses recurse."""
    out = {}
    for f in dataclasses.fields(v):
        x = getattr(v, f.name)
        if isinstance(x, WindowPolicy):
            x = x.to_dict()
        elif dataclasses.is_dataclass(x):
            x = _section_to_dict(x)
        elif isinstance(x, tuple):
            x = [_section_to_dict(e) if dataclasses.is_dataclass(e) else e
                 for e in x]
        out[f.name] = x
    return out


def _fleet_from_dict(d: Dict) -> FleetSpec:
    d = dict(d)
    if "profile" in d:
        d["profile"] = NodeHeterogeneity(**d["profile"])
    if "attack" in d:
        d["attack"] = AttackMix(**d["attack"])
    if "hw" in d:
        d["hw"] = tuple(d["hw"])
    return FleetSpec(**d)


def _schedule_from_dict(d: Dict) -> SchedulePolicy:
    d = dict(d)
    if "window" in d and not isinstance(d["window"], WindowPolicy):
        d["window"] = window_policy_from_dict(d["window"])
    return SchedulePolicy(**d)


def _obs_from_dict(d) -> ObsSpec:
    if isinstance(d, ObsSpec):
        return d
    d = dict(d)
    h = d.get("health")
    if h is not None and not isinstance(h, HealthSpec):
        d["health"] = HealthSpec(**h)
    return ObsSpec(**d)


def _sim_from_dict(d) -> Optional[SimSpec]:
    if d is None or isinstance(d, SimSpec):
        return d
    d = dict(d)
    d["traces"] = tuple(
        t if isinstance(t, TrafficTrace) else TrafficTrace(**t)
        for t in d.get("traces", ()))
    d["events"] = tuple(
        e if isinstance(e, SimEvent) else SimEvent(**e)
        for e in d.get("events", ()))
    return SimSpec(**d)
