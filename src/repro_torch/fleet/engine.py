"""FleetEngine: cohort-batched synchronous federated rounds.

Port of `repro.fleet.engine`.  Each round runs

  local SGD -> delta -> [DGC sparsify] -> [ALDP clip+noise]
            -> cloud detection (Alg. 2) -> masked aggregate -> Eq. (6) mix

over the whole cohort at once: `torch.func.vmap` of the local-SGD step
over nodes, the fused upload kernel over the flattened cohort, and the
cohort's residual rows written back in place.  The PRNG chain and the
minibatch draws are the reference's (`prng`), so with equal params the
two engines train on the same batches.  With a `net.NetSim` attached,
each round's measured nonzero counts are priced through the wire codec
and the link model's transfer times replace the analytic uplink.  An
`stages.AttackPlan` scales the sybil and adaptive attackers' uploads and
adds the DDoS flood to the link draws; the trust-weighted defense
aggregates with `detection.trust_weights`.  With a tracer enabled each
round emits a ``round`` span, one ``detect.verdict`` instant per
participant and the round metrics; with ``stage_timings`` its stages are
timed, each fenced on the card.

With a `mesh.FleetMesh` the node axis is sharded over the ranks of a
`torch.distributed` group and the round runs as `_build_round_sharded`:
each rank trains its block of nodes, the accuracies are all-gathered for
a replicated Alg. 2, and the mean is a sum of per-rank partial sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from ..core import async_update, detection
from ..device import resolve
from ..obs import WINDOW_SIZE_EDGES, get_tracer, timed_stage
from . import mesh as mesh_lib
from . import stages
from .mesh import FleetMesh, MeshStateIO
from .state import (FleetState, broadcast_tree, gather_nodes,
                    init_fleet_state, pad_keys)


# ---------------------------------------------------------------------------
# client sampling
# ---------------------------------------------------------------------------

class ClientSampler:
    """Selects each round's cohort: `cohort(round_idx, n_nodes)` returns
    (idx (C,), valid (C,)); invalid slots contribute nothing."""

    def cohort(self, round_idx: int, n_nodes: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class FullParticipation(ClientSampler):
    """Every node, every round (the paper's synchronous barrier)."""

    def cohort(self, round_idx, n_nodes):
        return np.arange(n_nodes), np.ones(n_nodes, bool)


class UniformSampler(ClientSampler):
    """Uniform-C sampling without replacement (FedAvg's 'm of K')."""

    def __init__(self, cohort_size: int, seed: int = 0):
        self.cohort_size = int(cohort_size)
        self.rng = np.random.default_rng(seed)

    def cohort(self, round_idx, n_nodes):
        c = min(self.cohort_size, n_nodes)
        idx = self.rng.choice(n_nodes, size=c, replace=False)
        return idx, np.ones(c, bool)


class AvailabilityTrace(ClientSampler):
    """Availability/churn: node k answers round r with prob p_k (or per an
    explicit (rounds, N) boolean trace); unavailable slots are padded."""

    def __init__(self, probs: Optional[np.ndarray] = None,
                 trace: Optional[np.ndarray] = None, seed: int = 0):
        if (probs is None) == (trace is None):
            raise ValueError("give exactly one of probs= or trace=")
        self.probs = None if probs is None else np.asarray(probs, np.float64)
        self.trace = None if trace is None else np.asarray(trace, bool)
        self.rng = np.random.default_rng(seed)

    def cohort(self, round_idx, n_nodes):
        src = self.trace if self.trace is not None else self.probs
        width = src.shape[-1]
        if width < n_nodes:
            raise ValueError(
                f"availability {'trace' if self.trace is not None else 'probs'}"
                f" covers {width} nodes but the fleet has {n_nodes}")
        if self.trace is not None:
            up = self.trace[round_idx % len(self.trace)][:n_nodes]
        else:
            up = self.rng.random(n_nodes) < self.probs[:n_nodes]
        if not up.any():              # never let a round starve entirely
            up = up.copy()
            up[self.rng.integers(n_nodes)] = True
        return np.arange(n_nodes), up


# ---------------------------------------------------------------------------
# per-node system model
# ---------------------------------------------------------------------------

@dataclass
class NodeProfile:
    """Per-node compute time and uplink bandwidth."""
    compute_s: np.ndarray          # (N,) seconds per local round
    bandwidth_bps: np.ndarray      # (N,) uplink bytes/s

    @classmethod
    def lognormal(cls, n_nodes: int, base_compute_s: float,
                  heterogeneity: float, bandwidth_bps: float,
                  seed: int = 0, straggler_frac: float = 0.0,
                  straggler_slowdown: float = 10.0) -> "NodeProfile":
        """Lognormal speeds + optional straggler tail (the reference's
        draws, in the same order)."""
        rng = np.random.default_rng(seed)
        comp = base_compute_s * np.exp(rng.normal(0.0, heterogeneity, n_nodes))
        n_strag = int(round(straggler_frac * n_nodes))
        if n_strag:
            comp[rng.choice(n_nodes, n_strag, replace=False)] *= \
                straggler_slowdown
        bw = np.full(n_nodes, float(bandwidth_bps))
        return cls(compute_s=comp, bandwidth_bps=bw)

    def round_times(self, idx: np.ndarray, valid: np.ndarray,
                    bytes_per_node: float) -> Tuple[float, float]:
        """(comp, comm) of a barrier round: the slowest participant."""
        sel = idx[valid]
        if sel.size == 0:
            return 0.0, 0.0
        comp = float(self.compute_s[sel].max())
        comm = float((bytes_per_node / self.bandwidth_bps[sel]).max())
        return comp, comm


# ---------------------------------------------------------------------------
# config + records
# ---------------------------------------------------------------------------

@dataclass
class FleetConfig:
    local_steps: int = 10
    batch_size: int = 64
    lr: float = 0.05
    alpha: float = 0.5              # Eq. (6)
    clip_s: float = 1.0
    sigma: float = 0.0              # noise multiplier (0 disables ALDP)
    detect: bool = True
    detect_s: float = 80.0
    sparsify_ratio: float = 1.0
    key_mode: str = "parallel"      # parallel | sequential (seed-loop parity)
    backend: str = "reference"      # reference | pallas (the CUDA kernels)
    seed: int = 0
    # trust-scored defense (api.DefenseSpec.kind="trust_weighted"): a
    # verdict EWMA per node, trust/uncertainty-weighted aggregation
    defense_kind: str = "percentile"   # percentile | trust_weighted
    trust_eta: float = 0.25
    trust_floor: float = 0.05
    uncertainty_scale: float = 4.0

    @property
    def trust_on(self) -> bool:
        return self.detect and self.defense_kind == "trust_weighted"


@dataclass
class FleetRoundRecord:
    t: float
    round: int
    accuracy: float
    comm_bytes: float
    comp_time: float
    comm_time: float
    n_participating: int
    n_rejected: int


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def check_mesh(mesh, device) -> torch.device:
    """The device an engine runs on: ``device`` resolved, and on a
    ``mesh`` this rank's device for it (TypeError for anything that is
    not a `FleetMesh`)."""
    dev = resolve(device)
    if mesh is None:
        return dev
    if not isinstance(mesh, FleetMesh):
        raise TypeError(f"mesh must be a repro_torch.fleet.FleetMesh, got "
                        f"{type(mesh).__name__}")
    return mesh.device(dev)


class FleetEngine(MeshStateIO):
    """Cohort-batched synchronous FEL over a stacked node fleet
    (``device="cuda"`` by default; raises without a card unless
    ``device="cpu"``).

    Args: init_params (dict of tensors), loss_fn (params, batch) -> (loss,
    aux), acc_fn (params, x, y) -> accuracy, node_data (list of numpy
    (x, y) shards or a `FleetData`), test_data, cloud_test, cfg, profile,
    sampler, mesh (an optional `FleetMesh`: the node axis sharded over its
    ranks, each rank running this engine in its own process), net (an
    optional `net.NetSim`), tracer (an `obs.Tracer`; defaults to the
    process-global one at construction), attack (an optional
    `stages.AttackPlan`) — as in the reference.  On a mesh the sequential
    PRNG chain is consumed once per node in node order, as an arange
    cohort consumes it (`FullParticipation`, `AvailabilityTrace`)."""

    def __init__(self, init_params, loss_fn: Callable, acc_fn: Callable,
                 node_data, test_data, cloud_test, cfg: FleetConfig,
                 profile: Optional[NodeProfile] = None,
                 sampler: Optional[ClientSampler] = None,
                 mesh: Optional[FleetMesh] = None, net=None,
                 device=None, tracer=None, attack=None):
        self.device = check_mesh(mesh, device)
        self.mesh = mesh
        self.cfg = cfg
        # events and metrics go to the injected tracer, else whatever
        # global one `api.run` scoped in (disabled -> all no-ops); the
        # round already returns accs/mask/thr, so tracing reads them and
        # changes nothing the round computes
        self.obs = tracer if tracer is not None else get_tracer()
        self.net = net
        self.attack = attack
        self.params = tree_util.map(lambda x: x.to(self.device), init_params)
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        (self.data, self.n_nodes, self.test_data, self.cloud_test,
         self.profile, self.n_params) = stages.init_engine_common(
            self.params, node_data, test_data, cloud_test, profile,
            self.device, mesh)
        self.sampler = sampler or FullParticipation()
        self.n_pad = mesh.padded(self.n_nodes) if mesh else self.n_nodes
        self.state = init_fleet_state(
            self.params, self.data.x.shape[0], prng.PRNGKey(cfg.seed),
            trust=cfg.trust_on,
            throttle=attack is not None and attack.needs_throttle)
        self.history: List[FleetRoundRecord] = []
        # barrier-clock origin: run_round continues from the last record's
        # t, or from here when the history is empty (a checkpoint restore
        # sets it, so the resumed clock does not restart at zero)
        self._t0 = 0.0
        self._round_fn = (self._build_round() if mesh is None
                          else self._build_round_sharded())

    def bytes_per_node(self) -> float:
        return stages.bytes_per_node(self.n_params, self.cfg.sparsify_ratio)

    # -- one round ------------------------------------------------------------
    def _build_round(self):
        cfg = self.cfg
        acc_fn = self.acc_fn
        cloud_x, cloud_y = self.cloud_test
        local_train = stages.make_local_train(self.loss_fn, cfg.local_steps,
                                              cfg.lr, cfg.batch_size)
        data, dev = self.data, self.device
        need_nnz = self.net is not None     # byte-accurate pricing only
        attack_stage = stages.make_delta_attack(self.attack)
        mal_full = (self.attack.mask(dev) if attack_stage is not None
                    else None)
        adapt_scale = self.attack.adapt_poison_scale if self.attack else 1.0

        def round_fn(params, residuals, chain_key, idx, valid, trust=None,
                     throttle=None):
            c = idx.shape[0]
            idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
            valid_t = torch.as_tensor(valid, device=dev)
            res_c = gather_nodes(residuals, idx_t)
            if cfg.key_mode == "sequential":
                chain_key, k1s, k2s = prng.chain_node_keys(chain_key, c)
            else:
                chain_key, k1s, k2s = prng.parallel_node_keys(chain_key, c)
            bidx = stages.batch_indices(k1s, data.sizes[idx],
                                        cfg.local_steps, cfg.batch_size, dev)
            local = local_train(broadcast_tree(params, c), data.x, data.y,
                                idx_t, bidx)
            deltas = tree_util.map(lambda l, g: l - g[None].to(l.dtype),
                                   local, params)
            if attack_stage is not None:
                deltas = attack_stage(
                    deltas, mal_full.index_select(0, idx_t),
                    throttle.index_select(0, idx_t)
                    if throttle is not None else None)
            deltas, res_c, nnz = stages.upload_pipeline(
                cfg, deltas, res_c, k2s, need_nnz=need_nnz)
            if need_nnz:            # lands by the time the mask is read
                nnz = nnz.to("cpu", non_blocking=True)
            omegas, accs = stages.rebuild_and_evaluate(
                acc_fn, params, deltas, cloud_x, cloud_y)
            if cfg.detect:
                mask, thr = stages.detect_masked(accs, valid_t,
                                                 cfg.detect_s)
            else:
                mask, thr = valid_t, torch.zeros((), device=dev)
            if trust is not None:
                w = detection.trust_weights(
                    trust.index_select(0, idx_t), accs, mask,
                    cfg.trust_floor, cfg.uncertainty_scale)
                omega_mean = detection.masked_weighted_mean(omegas, mask, w)
            else:
                omega_mean = detection.masked_mean(omegas, mask)
            new_params = async_update.mix(params, omega_mean, cfg.alpha)
            # participants' rows advance in place
            keep = torch.as_tensor(np.flatnonzero(valid), device=dev)
            rows = idx_t[keep]
            tree_util.map(lambda full, part: full.index_copy_(
                0, rows, part[keep]), residuals, res_c)
            if trust is not None:
                t_new = detection.trust_update(
                    trust.index_select(0, idx_t), mask, valid_t,
                    cfg.trust_eta)
                trust.index_copy_(0, rows, t_new[keep])
            if throttle is not None:
                th_new = stages.adaptive_throttle_update(
                    throttle.index_select(0, idx_t), valid_t & ~mask,
                    valid_t, adapt_scale)
                throttle.index_copy_(0, rows, th_new[keep])
            m = {"accs": accs, "mask": mask, "thr": thr}
            if need_nnz:
                m["nnz"] = nnz
            return new_params, residuals, chain_key, m

        return round_fn

    # -- the sharded round: every rank trains its block --------------------
    def _build_round_sharded(self):
        """The round over the node mesh, run by every rank on its block.

        Each rank trains its B = n_pad/D nodes (local SGD -> DGC -> ALDP
        -> cloud evaluation) with no communication; Alg. 2 needs the
        global accuracy set, so the (n_pad,) accuracies are all-gathered
        and thresholded replicated; the masked (or trust-weighted) mean
        is a per-rank partial sum of the flattened models, one
        `all_reduce`.  Cohorts arrive as a per-node participation mask:
        every padded or absent row trains and is masked out, so no cohort
        rows move between ranks."""
        cfg, mesh = self.cfg, self.mesh
        acc_fn = self.acc_fn
        cloud_x, cloud_y = self.cloud_test
        local_train = stages.make_local_train(self.loss_fn, cfg.local_steps,
                                              cfg.lr, cfg.batch_size)
        data, dev = self.data, self.device
        n, n_pad = self.n_nodes, self.n_pad
        blk = lambda x: mesh_lib.my_block(x, mesh)  # noqa: E731
        rows = torch.arange(n_pad // mesh.n_devices, device=dev)
        sizes = blk(data.sizes)
        need_nnz = self.net is not None     # byte-accurate pricing only
        attack_stage = stages.make_delta_attack(self.attack)
        mal_blk = None
        if attack_stage is not None:
            mal = np.zeros(n_pad, bool)
            mal[:n] = self.attack.malicious
            mal_blk = torch.as_tensor(blk(mal), device=dev)
        adapt_scale = self.attack.adapt_poison_scale if self.attack else 1.0

        def round_fn(params, residuals, chain_key, up, trust=None,
                     throttle=None):
            # keys over the true node count, then padded: the per-node
            # streams of an arange cohort on one device (padding rows
            # reuse the last real key for their masked-out updates)
            if cfg.key_mode == "sequential":
                chain_key, k1s, k2s = prng.chain_node_keys(chain_key, n)
            else:
                chain_key, k1s, k2s = prng.parallel_node_keys(chain_key, n)
            k1, k2 = blk(pad_keys(k1s, n_pad)), blk(pad_keys(k2s, n_pad))
            bidx = stages.batch_indices(k1, sizes, cfg.local_steps,
                                        cfg.batch_size, dev)
            local = local_train(broadcast_tree(params, rows.shape[0]),
                                data.x, data.y, rows, bidx)
            deltas = tree_util.map(lambda l, g: l - g[None].to(l.dtype),
                                   local, params)
            if attack_stage is not None:
                deltas = attack_stage(deltas, mal_blk, throttle)
            deltas, res_new, nnz = stages.upload_pipeline(
                cfg, deltas, residuals, k2, need_nnz=need_nnz)
            omegas, accs = stages.rebuild_and_evaluate(
                acc_fn, params, deltas, cloud_x, cloud_y)

            # cloud side, replicated: the global accuracy set -> Alg. 2
            accs_all = mesh_lib.all_gather(accs.to(torch.float32), mesh)
            valid_all = torch.as_tensor(up, device=dev)
            if cfg.detect:
                mask_all, thr = stages.detect_masked(accs_all, valid_all,
                                                     cfg.detect_s)
            else:
                mask_all, thr = valid_all, torch.zeros((), device=dev)
            mask, valid = blk(mask_all), blk(valid_all)
            if trust is not None:
                # trust weights against the global accepted-mean accuracy
                # (every rank shares the anchor)
                m_all = mask_all.to(torch.float32)
                ref = ((accs_all * m_all).sum()
                       / torch.clamp(m_all.sum(), min=1.0))
                w = mask.to(torch.float32) * detection.trust_weights(
                    trust, accs, mask, cfg.trust_floor,
                    cfg.uncertainty_scale, ref=ref)
                total = mesh_lib.all_reduce_sum(w.sum())
                denom = torch.where(total > 0, total, torch.ones_like(total))
            else:
                w = mask.to(torch.float32)
                denom = torch.clamp(mesh_lib.all_reduce_sum(w.sum()),
                                    min=1.0)
            layout = stages.cohort_layout(omegas)
            part = (layout.flatten(omegas) * w[:, None]).sum(0)
            omega_mean = layout.unflatten_one(
                mesh_lib.all_reduce_sum(part) / denom)
            new_params = async_update.mix(params, omega_mean, cfg.alpha)

            # participants' rows advance in place; everyone else's stay
            keep = torch.nonzero(valid).reshape(-1)
            tree_util.map(lambda full, part: full.index_copy_(
                0, keep, part.index_select(0, keep)), residuals, res_new)
            if trust is not None:
                trust.copy_(detection.trust_update(trust, mask, valid,
                                                   cfg.trust_eta))
            if throttle is not None:
                throttle.copy_(stages.adaptive_throttle_update(
                    throttle, valid & ~mask, valid, adapt_scale))
            m = {"accs": accs_all, "mask": mask_all, "thr": thr}
            if need_nnz:
                m["nnz"] = mesh_lib.all_gather(nnz, mesh).cpu()
            return new_params, residuals, chain_key, m

        return round_fn

    def run_round(self) -> FleetRoundRecord:
        tr = self.obs
        r = self.state.round
        span = tr.span("round", round=r)
        span.__enter__()
        idx, valid = self.sampler.cohort(r, self.n_nodes)
        idx, valid = np.asarray(idx), np.asarray(valid, bool)
        st = self.state
        up = None
        with timed_stage(tr, "round.device", round=r) as stage:
            if self.mesh is not None:
                up = self._participation_mask(idx, valid)
                self.params, residuals, chain_key, m = self._round_fn(
                    self.params, st.residuals, st.chain_key, up, st.trust,
                    st.throttle)
            else:
                self.params, residuals, chain_key, m = self._round_fn(
                    self.params, st.residuals, st.chain_key, idx, valid,
                    st.trust, st.throttle)
            stage.fence((self.params, m))
        self.state = FleetState(residuals=residuals, chain_key=chain_key,
                                round=r + 1, trust=st.trust,
                                throttle=st.throttle)
        n_part = int(valid.sum())
        mask = m["mask"].cpu().numpy()
        if up is not None:      # sharded: per-node arrays over n_pad
            n_rejected = int((up & ~mask).sum())
            sel_nodes = np.flatnonzero(up[:self.n_nodes])
        else:                   # one device: cohort (idx) order
            n_rejected = int((valid & ~mask).sum())
            sel_nodes = idx[valid]
        bpn = self.bytes_per_node()
        comp, comm = self.profile.round_times(idx, valid, bpn)
        comm_bytes = bpn * n_part
        if self.net is not None:
            # byte-accurate path: each participant's measured nonzero
            # count priced through the codec; the link draws replace the
            # analytic uplink and the barrier waits on the slowest upload
            nnz = m["nnz"].numpy()
            nnz_sel = nnz[sel_nodes] if up is not None else nnz[valid]
            flood = self.attack.flood_uploads if self.attack else 0
            with timed_stage(tr, "net.draw", round=r):
                draw = self.net.draw(sel_nodes, extra_concurrency=flood)
            with timed_stage(tr, "net.commit", round=r):
                enc = self.net.commit(draw, nnz_sel, ctx={"round": r})
            comm = float(draw.transfer_s.max()) if sel_nodes.size else 0.0
            comm_bytes = float(enc.sum())
        t_prev = self.history[-1].t if self.history else self._t0
        with timed_stage(tr, "round.evaluate", round=r):
            accuracy = self.global_accuracy()
        rec = FleetRoundRecord(
            t=t_prev + comp + comm, round=r,
            accuracy=accuracy, comm_bytes=comm_bytes,
            comp_time=comp, comm_time=comm, n_participating=n_part,
            n_rejected=n_rejected)
        self.history.append(rec)
        if tr.enabled:
            self._emit_round_events(rec, idx, valid, m, mask, up)
        span.set(n_participating=n_part, n_rejected=n_rejected)
        span.set_virtual(t_prev, rec.t)
        span.__exit__(None, None, None)
        return rec

    def _emit_round_events(self, rec: FleetRoundRecord, idx, valid, m,
                           mask, up=None) -> None:
        """Per-participant detection audit (one `detect.verdict` instant
        per cloud evaluation, Alg. 2's batch top-s form) + round metrics:
        the trace alone rebuilds Fig. 6's per-round rejection series."""
        tr = self.obs
        thr = float(m["thr"])
        accs = m["accs"].cpu().numpy()
        if up is not None:      # sharded: node-order arrays over n_pad
            nodes = np.flatnonzero(up[:self.n_nodes])
            accs, mask = accs[nodes], mask[nodes]
        else:                   # one device: cohort (idx) order
            nodes = idx[valid]
            accs, mask = accs[valid], mask[valid]
        for i, node in enumerate(nodes):
            tr.instant("detect.verdict", virt_t=rec.t, node=int(node),
                       round=rec.round, accuracy=float(accs[i]),
                       threshold=thr, rejected=bool(~mask[i]),
                       detect=bool(self.cfg.detect))
        mx = tr.metrics
        if self.cfg.detect and nodes.size and detection.detect_fell_back(
                accs, thr):
            # the all-equal guard accepted everyone — the exact state a
            # detection-aware attacker forces; auditable from the trace
            mx.counter("detect.fallback").inc()
        mx.histogram("round.size", WINDOW_SIZE_EDGES).observe(
            rec.n_participating)
        mx.counter("round.participants").inc(rec.n_participating)
        mx.counter("round.rejected").inc(rec.n_rejected)
        mx.counter("round.comm_bytes").inc(rec.comm_bytes)
        mx.gauge("model.accuracy").set(rec.accuracy)

    def run(self, rounds: int) -> List[FleetRoundRecord]:
        for _ in range(rounds):
            self.run_round()
        return self.history

    def global_accuracy(self) -> float:
        return float(self.acc_fn(self.params, *self.test_data))

    def kappa(self) -> float:
        """Eq. (5) over the whole run."""
        comm = sum(r.comm_time for r in self.history)
        comp = sum(r.comp_time for r in self.history)
        return async_update.communication_efficiency(comm, comp)
