"""Spec -> plan: validate cross-field constraints once, select the engine.

Port of `repro.api.plan`: the same validation with the same `SpecError`
messages and the same plans.

`compile_plan` is the single choke point between a declarative
`ExperimentSpec` and execution: it checks every cross-field constraint
(mesh topology needs the fleet engines, no accountant when σ=0, window
policies only on windowed schedules, ...) with explicit errors, resolves
derived quantities (the calibrated noise multiplier, the detection window)
and returns an `ExperimentPlan` naming the engine and the pipeline stages
that will run.  `run.run` consumes plans, never raw specs — so invalid
axis combinations fail loudly at compile time, not silently mid-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from ..core import aldp, detection
from ..net.codecs import CODEC_NAMES, SparseBitpack
from .spec import (SIM_EVENT_KINDS, TRACE_KINDS, ExperimentSpec,
                   apply_sim_event)
from .window import AutoWindow, FixedWindow, TargetArrivalsWindow

SCHEDULE_KINDS = ("sync", "async", "buffered")
TOPOLOGY_KINDS = ("sequential", "single", "mesh")
BACKENDS = ("reference", "pallas")
NET_CODECS = ("analytic",) + CODEC_NAMES
ATTACK_KINDS = ("label_flip", "sybil", "backdoor", "adaptive", "ddos")
DEFENSE_KINDS = ("percentile", "trust_weighted")
PLACEMENTS = ("random", "first")


class SpecError(ValueError):
    """An `ExperimentSpec` with contradictory or out-of-range fields."""


@dataclass(frozen=True)
class ExperimentPlan:
    """A validated, lowered experiment: which engine, which stages.

    Plans are produced by `compile_plan` only; the runner trusts them.
    """
    spec: ExperimentSpec
    mode: str                   # "sync" | "async" (execution family)
    engine: str                 # "sequential" | "fleet"
    mixing: str                 # "barrier" | "sequential" | "buffered"
    mesh_devices: Optional[int]  # None = unsharded; 0 = all local devices
    sigma: float                # resolved noise multiplier
    detect_window: int          # resolved async detection ring capacity
    total_arrivals: int         # async arrival budget (rounds * n_nodes)
    accountant: bool            # spend privacy budget? (sigma > 0)
    key_mode: str               # engine PRNG chain mode
    stages: Tuple[str, ...]     # descriptive upload/aggregate pipeline
    net_codec: Optional[str] = None  # repro.net wire codec; None = analytic

    def describe(self) -> str:
        placement = ("sequential reference loop" if self.engine == "sequential"
                     else "fleet engine"
                     + (f" over {self.mesh_devices or 'all'}-device mesh"
                        if self.mesh_devices is not None else ""))
        return (f"{self.spec.schedule.kind} schedule on {placement}: "
                + " -> ".join(self.stages))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def compile_plan(spec: ExperimentSpec) -> ExperimentPlan:
    """Validate ``spec`` and lower it to an `ExperimentPlan`.

    Raises `SpecError` (a ValueError) on any contradictory or out-of-range
    field combination.
    """
    f, sch, priv = spec.fleet, spec.schedule, spec.privacy
    comp, dfs, topo, tr = (spec.compression, spec.defense, spec.topology,
                           spec.train)

    # -- enumerations -------------------------------------------------------
    _require(sch.kind in SCHEDULE_KINDS,
             f"schedule.kind {sch.kind!r} not in {SCHEDULE_KINDS}")
    _require(topo.kind in TOPOLOGY_KINDS,
             f"topology.kind {topo.kind!r} not in {TOPOLOGY_KINDS}")
    _require(topo.backend in BACKENDS,
             f"topology.backend {topo.backend!r} not in {BACKENDS}")
    _require(f.model in ("mlp", "cnn"),
             f"fleet.model {f.model!r} not in ('mlp', 'cnn')")

    # -- ranges -------------------------------------------------------------
    _require(f.n_nodes >= 1, f"fleet.n_nodes must be >= 1, got {f.n_nodes}")
    _require(spec.rounds >= 1, f"rounds must be >= 1, got {spec.rounds}")
    _require(tr.local_steps >= 1 and tr.batch_size >= 1,
             "train.local_steps and train.batch_size must be >= 1")
    _require(tr.lr > 0, f"train.lr must be > 0, got {tr.lr}")
    _require(0.0 <= sch.alpha <= 1.0,
             f"schedule.alpha must be in [0, 1], got {sch.alpha}")
    _require(0.0 < comp.sparsify_ratio <= 1.0,
             f"compression.sparsify_ratio must be in (0, 1], got "
             f"{comp.sparsify_ratio}")
    _require(0.0 < dfs.detect_s < 100.0,
             f"defense.detect_s is a percentile in (0, 100), got "
             f"{dfs.detect_s}")
    _require(dfs.detect_warmup >= 1,
             f"defense.detect_warmup must be >= 1, got {dfs.detect_warmup}")
    _require(dfs.detect_window is None or dfs.detect_window >= 1,
             f"defense.detect_window must be >= 1, got {dfs.detect_window}")
    _require(0.0 < f.availability <= 1.0,
             f"fleet.availability must be in (0, 1], got {f.availability}")
    _require(0.0 < f.cohort_frac <= 1.0,
             f"fleet.cohort_frac must be in (0, 1], got {f.cohort_frac}")
    _require(0.0 <= f.attack.malicious_frac <= 1.0,
             "fleet.attack.malicious_frac must be in [0, 1]")
    _require(0.0 <= f.profile.straggler_frac <= 1.0,
             "fleet.profile.straggler_frac must be in [0, 1]")
    _require(f.profile.base_compute_s > 0 and f.profile.bandwidth_bps > 0,
             "fleet.profile.base_compute_s and bandwidth_bps must be > 0")
    _require(f.profile.heterogeneity >= 0,
             "fleet.profile.heterogeneity must be >= 0")
    _require(f.samples_per_node >= 1,
             "fleet.samples_per_node must be >= 1")
    _require(f.dirichlet_alpha > 0,
             f"fleet.dirichlet_alpha must be > 0, got {f.dirichlet_alpha}")

    # -- cross-field contradictions -----------------------------------------
    _require(not (f.availability < 1.0 and f.cohort_frac < 1.0),
             "fleet.availability < 1 and fleet.cohort_frac < 1 are two "
             "different participation models — declare exactly one")
    _require(not (topo.kind == "mesh" and topo.devices is not None
                  and topo.devices < 1),
             f"topology.devices must be >= 1, got {topo.devices}")
    _require(not (topo.kind != "mesh" and topo.devices is not None),
             f"topology.devices={topo.devices} is set but topology.kind="
             f"{topo.kind!r} is not 'mesh' — a mesh size without a mesh "
             f"is a contradiction, not a default")
    _require(not (topo.kind == "sequential" and sch.kind == "buffered"),
             "buffered aggregation has no sequential reference loop — use "
             "topology.kind='single' or 'mesh'")
    _require(not (topo.kind == "sequential" and topo.backend == "pallas"),
             "the sequential reference loop has no pallas upload pipeline — "
             "use topology.kind='single' or 'mesh'")
    _require(not (sch.kind == "sync" and sch.staleness_adaptive),
             "schedule.staleness_adaptive weights staleness τ, which a "
             "synchronous barrier never has — use kind='async'")
    _require(sch.staleness_a > 0,
             f"schedule.staleness_a must be > 0, got {sch.staleness_a}")

    # -- window policy ------------------------------------------------------
    win = sch.window
    if sch.kind == "sync":
        _require(isinstance(win, AutoWindow),
                 f"schedule.window={type(win).__name__} but kind='sync' has "
                 f"no arrival windows — window policies apply to "
                 f"async/buffered schedules")
    if isinstance(win, FixedWindow):
        _require(win.seconds > 0,
                 f"FixedWindow: window must be positive, got {win.seconds}")
    if isinstance(win, TargetArrivalsWindow):
        _require(sch.kind == "buffered",
                 "TargetArrivalsWindow batches many arrivals per window, "
                 "which reorders them vs the event loop — only the buffered "
                 "schedule (order-free masked-mean mix) supports it")
        _require(win.target_arrivals >= 1,
                 f"TargetArrivalsWindow.target_arrivals must be >= 1, got "
                 f"{win.target_arrivals}")
    if not isinstance(win, AutoWindow) and topo.kind == "sequential":
        raise SpecError("the sequential reference loop processes arrivals "
                        "one at a time — window policies need the fleet "
                        "engines (topology.kind='single' or 'mesh')")

    # -- network ------------------------------------------------------------
    net = spec.network
    _require(net.codec in NET_CODECS,
             f"network.codec {net.codec!r} not in {NET_CODECS}")
    _require(net.value_bits in SparseBitpack.VALUE_BITS,
             f"network.value_bits must be one of "
             f"{SparseBitpack.VALUE_BITS}, got {net.value_bits}")
    _require(net.value_bits == 32 or net.codec == "sparse_bitpack",
             f"network.value_bits={net.value_bits} is the sparse_bitpack "
             f"quantized-value variant; codec {net.codec!r} stores f32 "
             f"values")
    _require(0.0 <= net.loss_prob < 1.0,
             f"network.loss_prob must be in [0, 1), got {net.loss_prob}")
    _require(net.latency_s >= 0 and net.jitter_s >= 0,
             "network.latency_s and network.jitter_s must be >= 0")
    _require(net.bandwidth_sigma >= 0 and net.shared_uplink_bps >= 0,
             "network.bandwidth_sigma and network.shared_uplink_bps must "
             "be >= 0")
    _require(net.mtu_bytes >= 1,
             f"network.mtu_bytes must be >= 1, got {net.mtu_bytes}")
    if not net.enabled:
        _require(net.bandwidth_sigma == 0 and net.latency_s == 0
                 and net.jitter_s == 0 and net.loss_prob == 0
                 and net.shared_uplink_bps == 0,
                 "link simulation needs a wire codec — network.codec="
                 "'analytic' keeps the analytic comm model; pick "
                 "dense_f32/sparse_coo/sparse_bitpack to enable the link "
                 "parameters")
    else:
        _require(topo.kind != "sequential",
                 "the sequential reference loop has no network simulation "
                 "— use topology.kind='single' or 'mesh'")

    # -- adversary zoo + defense --------------------------------------------
    atk = f.attack
    attacking = atk.malicious_frac > 0.0
    _require(atk.kind in ATTACK_KINDS,
             f"fleet.attack.kind {atk.kind!r} not in {ATTACK_KINDS}")
    _require(atk.placement in PLACEMENTS,
             f"fleet.attack.placement {atk.placement!r} not in {PLACEMENTS}")
    _require(f.n_classes >= 2,
             f"fleet.n_classes must be >= 2, got {f.n_classes}")
    _require(0 <= atk.flip_src < f.n_classes,
             f"fleet.attack.flip_src={atk.flip_src} is not a class id in "
             f"[0, {f.n_classes}) — check fleet.n_classes")
    _require(0 <= atk.flip_dst < f.n_classes,
             f"fleet.attack.flip_dst={atk.flip_dst} is not a class id in "
             f"[0, {f.n_classes}) — check fleet.n_classes")
    _require(not (attacking and atk.kind in ("label_flip", "sybil", "adaptive")
                  and atk.flip_src == atk.flip_dst),
             f"fleet.attack.flip_src == flip_dst == {atk.flip_src} flips "
             f"every label onto itself — a silent no-op 'attack', not a "
             f"default")
    _require(atk.sybil_boost > 0,
             f"fleet.attack.sybil_boost must be > 0, got {atk.sybil_boost}")
    _require(0.0 < atk.adapt_poison_scale < 1.0,
             f"fleet.attack.adapt_poison_scale must be in (0, 1) — the "
             f"throttle must actually back off on rejection, got "
             f"{atk.adapt_poison_scale}")
    _require(0.0 < atk.trigger_frac <= 1.0,
             f"fleet.attack.trigger_frac must be in (0, 1], got "
             f"{atk.trigger_frac}")
    _require(0 <= atk.trigger_label < f.n_classes,
             f"fleet.attack.trigger_label={atk.trigger_label} is not a class "
             f"id in [0, {f.n_classes})")
    _require(1 <= atk.trigger_size <= min(f.hw),
             f"fleet.attack.trigger_size={atk.trigger_size} must fit the "
             f"{f.hw} image (1 <= size <= {min(f.hw)})")
    _require(atk.ddos_uploads >= 1,
             f"fleet.attack.ddos_uploads must be >= 1, got "
             f"{atk.ddos_uploads}")
    if attacking and atk.kind == "ddos":
        _require(net.enabled and net.shared_uplink_bps > 0,
                 "fleet.attack.kind='ddos' floods the shared uplink — it "
                 "needs a real network.codec and network.shared_uplink_bps "
                 "> 0 (the analytic comm model has no contention to abuse)")
    if attacking and atk.kind in ("sybil", "adaptive", "ddos"):
        _require(topo.kind != "sequential",
                 f"fleet.attack.kind={atk.kind!r} manipulates the engines' "
                 f"delta/verdict/link pipeline — the sequential reference "
                 f"loop only supports data-level attacks (label_flip, "
                 f"backdoor); use topology.kind='single' or 'mesh'")
    _require(dfs.kind in DEFENSE_KINDS,
             f"defense.kind {dfs.kind!r} not in {DEFENSE_KINDS}")
    _require(0.0 < dfs.trust_eta <= 1.0,
             f"defense.trust_eta must be in (0, 1], got {dfs.trust_eta}")
    _require(0.0 <= dfs.trust_floor <= 1.0,
             f"defense.trust_floor must be in [0, 1], got {dfs.trust_floor}")
    _require(dfs.uncertainty_scale >= 0,
             f"defense.uncertainty_scale must be >= 0, got "
             f"{dfs.uncertainty_scale}")
    if dfs.kind == "trust_weighted":
        _require(dfs.detect,
                 "defense.kind='trust_weighted' accumulates trust from "
                 "detection verdicts — it needs defense.detect=True")
        _require(topo.kind != "sequential",
                 "defense.kind='trust_weighted' keeps trust state in "
                 "FleetState — the sequential reference loop has none; use "
                 "topology.kind='single' or 'mesh'")

    # -- observability ------------------------------------------------------
    obs = spec.obs
    for name in ("events_jsonl", "chrome_trace", "records_jsonl"):
        path = getattr(obs, name)
        _require(path is None or (isinstance(path, str) and path != ""),
                 f"obs.{name} must be a non-empty path or None, got "
                 f"{path!r}")
        _require(path is None or obs.enabled,
                 f"obs.{name}={path!r} is set but obs.enabled=False — an "
                 f"output path without the tracer is a contradiction, not "
                 f"a default")
    _require(not (obs.stage_timings and not obs.enabled),
             "obs.stage_timings needs obs.enabled=True — fenced stage "
             "timing only exists inside a traced run")
    _require(not (obs.enabled and topo.kind == "sequential"
                  and obs.stage_timings),
             "obs.stage_timings times the fleet engines' pipeline stages — "
             "the sequential reference loop has none (use topology.kind="
             "'single' or 'mesh')")

    # -- fleet health (repro.obs.health) -------------------------------------
    hlt = obs.health
    if hlt is not None:
        _require(obs.enabled,
                 "obs.health declares SLO probes over the trace stream — "
                 "it needs obs.enabled=True")
        probes = hlt.enabled_probes()
        _require(len(probes) > 0,
                 "obs.health enables no probe — every threshold is 0/off; "
                 "set at least one of straggler_factor, "
                 "bytes_per_record_budget, reject_rate_threshold, "
                 "occupancy_floor")
        _require(hlt.straggler_factor == 0 or hlt.straggler_factor > 1.0,
                 f"obs.health.straggler_factor flags nodes slower than "
                 f"factor × the fleet median gap — it must be > 1 when "
                 f"set, got {hlt.straggler_factor}")
        _require(hlt.straggler_min_arrivals >= 2,
                 f"obs.health.straggler_min_arrivals must be >= 2 (one "
                 f"arrival has no cadence), got "
                 f"{hlt.straggler_min_arrivals}")
        _require(hlt.bytes_per_record_budget >= 0,
                 f"obs.health.bytes_per_record_budget must be >= 0, got "
                 f"{hlt.bytes_per_record_budget}")
        _require(0.0 <= hlt.reject_rate_threshold <= 1.0,
                 f"obs.health.reject_rate_threshold must be in [0, 1], "
                 f"got {hlt.reject_rate_threshold}")
        _require(hlt.reject_rate_window >= 1,
                 f"obs.health.reject_rate_window must be >= 1, got "
                 f"{hlt.reject_rate_window}")
        _require(0.0 <= hlt.occupancy_floor < 1.0,
                 f"obs.health.occupancy_floor must be in [0, 1), got "
                 f"{hlt.occupancy_floor}")
        _require(hlt.warmup_records >= 0,
                 f"obs.health.warmup_records must be >= 0, got "
                 f"{hlt.warmup_records}")
        if "straggler" in probes:
            _require(sch.kind != "sync",
                     "obs.health.straggler_factor scores arrival cadence — "
                     "sync barrier rounds emit no arrival instants; use "
                     "schedule.kind='async' or 'buffered'")
        if "byte_budget" in probes:
            _require(spec.network.enabled,
                     "obs.health.bytes_per_record_budget meters net.upload "
                     "events — it needs a real network codec "
                     "(network.codec != 'analytic')")
        if "reject_rate" in probes:
            _require(dfs.detect,
                     "obs.health.reject_rate_threshold watches the "
                     "detect.verdict audit log — it needs "
                     "defense.detect=True")

    # -- simulation service (repro.sim) -------------------------------------
    sim = spec.sim
    if sim is not None:
        _require(sim.checkpoint_every >= 0,
                 f"sim.checkpoint_every must be >= 0, got "
                 f"{sim.checkpoint_every}")
        _require(not (sim.checkpoint_every > 0 and not sim.checkpoint_dir),
                 "sim.checkpoint_every > 0 schedules automatic checkpoints "
                 "— it needs sim.checkpoint_dir")
        for i, trc in enumerate(sim.traces):
            _require(trc.kind in TRACE_KINDS,
                     f"sim.traces[{i}].kind {trc.kind!r} not in "
                     f"{TRACE_KINDS}")
            _require(0.0 <= trc.amplitude < 1.0,
                     f"sim.traces[{i}].amplitude must be in [0, 1) — an "
                     f"amplitude of 1 zeroes the link rate, got "
                     f"{trc.amplitude}")
            _require(0.0 < trc.node_frac <= 1.0,
                     f"sim.traces[{i}].node_frac must be in (0, 1], got "
                     f"{trc.node_frac}")
            _require(0.0 <= trc.region_start < 1.0,
                     f"sim.traces[{i}].region_start must be in [0, 1), got "
                     f"{trc.region_start}")
            if trc.kind == "diurnal":
                _require(trc.period_s > 0,
                         f"sim.traces[{i}] (diurnal) needs period_s > 0, "
                         f"got {trc.period_s}")
            else:
                _require(trc.duration_s > 0 and trc.t_start >= 0,
                         f"sim.traces[{i}] ({trc.kind}) is an epoch — needs "
                         f"duration_s > 0 and t_start >= 0, got "
                         f"({trc.t_start}, {trc.duration_s})")
            if trc.kind in ("diurnal", "flash_crowd"):
                _require(net.enabled,
                         f"sim.traces[{i}] ({trc.kind}) modulates link "
                         f"bandwidth — it needs a real network.codec "
                         f"(network.codec='analytic' has no links to "
                         f"throttle)")
            if trc.kind == "outage":
                _require(topo.kind != "sequential",
                         f"sim.traces[{i}] (outage) drops nodes via the "
                         f"churn sampler — the sequential reference loop "
                         f"has none; use topology.kind='single' or 'mesh'")
                _require(not (sch.kind == "sync" and trc.node_frac >= 1.0),
                         f"sim.traces[{i}]: a full-fleet outage would "
                         f"starve a synchronous barrier round — use "
                         f"node_frac < 1 on sync schedules")
        members = set(range(f.n_nodes))
        last_round = 0
        mutated = dataclasses.replace(spec, sim=None)
        for i, ev in enumerate(sim.events):
            _require(ev.kind in SIM_EVENT_KINDS,
                     f"sim.events[{i}].kind {ev.kind!r} not in "
                     f"{SIM_EVENT_KINDS}")
            _require(isinstance(ev.payload, dict),
                     f"sim.events[{i}].payload must be a dict, got "
                     f"{type(ev.payload).__name__}")
            _require(1 <= ev.at_round < spec.rounds,
                     f"sim.events[{i}].at_round={ev.at_round} must be in "
                     f"[1, rounds={spec.rounds}) — events fire between "
                     f"records")
            _require(ev.at_round >= last_round,
                     f"sim.events[{i}] fires at round {ev.at_round}, before "
                     f"sim.events[{i - 1}] at {last_round} — the timeline "
                     f"must be ordered by at_round")
            last_round = ev.at_round
            if ev.kind == "nodes":
                _require(topo.kind != "sequential",
                         f"sim.events[{i}] (nodes) churns membership via "
                         f"the dynamic sampler — the sequential reference "
                         f"loop has none; use topology.kind='single' or "
                         f"'mesh'")
                _require(set(ev.payload) <= {"join", "leave"},
                         f"sim.events[{i}] (nodes) payload keys must be a "
                         f"subset of {{'join', 'leave'}}, got "
                         f"{sorted(ev.payload)}")
                for kk in ("join", "leave"):
                    ids = ev.payload.get(kk, [])
                    _require(all(isinstance(x, int) and 0 <= x < f.n_nodes
                                 for x in ids),
                             f"sim.events[{i}] (nodes) {kk} ids must be "
                             f"node ids in [0, {f.n_nodes}), got {ids}")
                members -= set(ev.payload.get("leave", []))
                members |= set(ev.payload.get("join", []))
                _require(len(members) >= 1,
                         f"sim.events[{i}] (nodes) would leave the fleet "
                         f"empty at round {ev.at_round}")
            else:
                try:
                    mutated = apply_sim_event(mutated, ev)
                except (TypeError, ValueError) as e:
                    raise SpecError(
                        f"sim.events[{i}] ({ev.kind}): bad payload "
                        f"{ev.payload!r} — {e}") from e
                try:
                    compile_plan(mutated)
                except SpecError as e:
                    raise SpecError(
                        f"sim.events[{i}] ({ev.kind}) at round "
                        f"{ev.at_round} yields an invalid spec: {e}") from e

    # -- privacy resolution -------------------------------------------------
    if priv.sigma is None:
        _require(priv.epsilon > 0 and 0.0 < priv.delta < 1.0,
                 f"privacy.sigma=None calibrates from (epsilon, delta); "
                 f"need epsilon > 0 and delta in (0, 1), got "
                 f"({priv.epsilon}, {priv.delta})")
        sigma = aldp.sigma_for_epsilon(priv.epsilon, priv.delta)
    else:
        _require(priv.sigma >= 0,
                 f"privacy.sigma must be >= 0 (0 = no noise), got "
                 f"{priv.sigma}")
        sigma = float(priv.sigma)
    _require(priv.clip_s > 0, f"privacy.clip_s must be > 0, got "
             f"{priv.clip_s}")

    # -- lowering -----------------------------------------------------------
    mode = "sync" if sch.kind == "sync" else "async"
    engine = "sequential" if topo.kind == "sequential" else "fleet"
    mixing = {"sync": "barrier", "async": "sequential",
              "buffered": "buffered"}[sch.kind]
    mesh_devices = ((topo.devices if topo.devices is not None else 0)
                    if topo.kind == "mesh" else None)
    detect_window = (dfs.detect_window if dfs.detect_window is not None
                     else detection.default_window(f.n_nodes))

    stages = ["local_sgd"]
    if attacking:
        stages.append(f"attack[{atk.kind}]")
    if comp.sparsify_ratio < 1.0:
        stages.append("dgc_sparsify")
    if sigma > 0:
        stages.append("aldp_perturb")
    if net.enabled:
        stages.append(f"wire_encode[{net.codec}]")
        stages.append("link_sim")
    if dfs.detect:
        stages.append("cloud_detect")
        if dfs.kind == "trust_weighted":
            stages.append("trust_weighted_agg")
    if obs.enabled:
        stages.append("obs_trace")
    if obs.health is not None:
        stages.append("health_probes")
    stages.append({"barrier": "masked_mean_mix",
                   "sequential": "eq6_arrival_mix",
                   "buffered": "fedbuff_window_mix"}[mixing])

    return ExperimentPlan(
        spec=spec, mode=mode, engine=engine, mixing=mixing,
        mesh_devices=mesh_devices, sigma=sigma, detect_window=detect_window,
        total_arrivals=spec.rounds * f.n_nodes, accountant=sigma > 0,
        key_mode="sequential", stages=tuple(stages),
        net_codec=net.codec if net.enabled else None)
