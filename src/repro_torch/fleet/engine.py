"""FleetEngine: cohort-batched synchronous federated rounds.

Port of `repro.fleet.engine` for one device.  Each round runs

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
aggregates with `detection.trust_weights`.
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
from . import stages
from .state import FleetState, broadcast_tree, gather_nodes, init_fleet_state


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

class FleetEngine:
    """Cohort-batched synchronous FEL over a stacked node fleet, on one
    device (``device="cuda"`` by default; raises without a card unless
    ``device="cpu"``).

    Args: init_params (dict of tensors), loss_fn (params, batch) -> (loss,
    aux), acc_fn (params, x, y) -> accuracy, node_data (list of numpy
    (x, y) shards or a `FleetData`), test_data, cloud_test, cfg, profile,
    sampler, net (an optional `net.NetSim`), attack (an optional
    `stages.AttackPlan`) — as in the reference."""

    def __init__(self, init_params, loss_fn: Callable, acc_fn: Callable,
                 node_data, test_data, cloud_test, cfg: FleetConfig,
                 profile: Optional[NodeProfile] = None,
                 sampler: Optional[ClientSampler] = None, net=None,
                 device=None, attack=None):
        self.device = resolve(device)
        self.cfg = cfg
        self.net = net
        self.attack = attack
        self.params = tree_util.map(lambda x: x.to(self.device), init_params)
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        (self.data, self.n_nodes, self.test_data, self.cloud_test,
         self.profile, self.n_params) = stages.init_engine_common(
            self.params, node_data, test_data, cloud_test, profile,
            self.device)
        self.sampler = sampler or FullParticipation()
        self.state = init_fleet_state(
            self.params, self.n_nodes, prng.PRNGKey(cfg.seed),
            trust=cfg.trust_on,
            throttle=attack is not None and attack.needs_throttle)
        self.history: List[FleetRoundRecord] = []
        self._t0 = 0.0
        self._round_fn = self._build_round()

    def load_state(self, residuals_stacked, chain_key) -> None:
        """Adopt externally-held stacked residuals and a chain key."""
        self.state.residuals = tree_util.map(
            lambda x: x.to(self.device, torch.float32).clone(),
            residuals_stacked)
        self.state.chain_key = np.asarray(chain_key, np.uint32)

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

    def run_round(self) -> FleetRoundRecord:
        r = self.state.round
        idx, valid = self.sampler.cohort(r, self.n_nodes)
        idx, valid = np.asarray(idx), np.asarray(valid, bool)
        st = self.state
        self.params, residuals, chain_key, m = self._round_fn(
            self.params, st.residuals, st.chain_key, idx, valid, st.trust,
            st.throttle)
        self.state = FleetState(residuals=residuals, chain_key=chain_key,
                                round=r + 1, trust=st.trust,
                                throttle=st.throttle)
        n_part = int(valid.sum())
        n_rejected = int((valid & ~m["mask"].cpu().numpy()).sum())
        bpn = self.bytes_per_node()
        comp, comm = self.profile.round_times(idx, valid, bpn)
        comm_bytes = bpn * n_part
        if self.net is not None:
            # byte-accurate path: each participant's measured nonzero
            # count priced through the codec (nnz is in cohort order); the
            # link draws replace the analytic uplink and the barrier waits
            # on the slowest upload
            sel_nodes = idx[valid]
            flood = self.attack.flood_uploads if self.attack else 0
            draw = self.net.draw(sel_nodes, extra_concurrency=flood)
            enc = self.net.commit(draw, m["nnz"].numpy()[valid])
            comm = float(draw.transfer_s.max()) if sel_nodes.size else 0.0
            comm_bytes = float(enc.sum())
        t_prev = self.history[-1].t if self.history else self._t0
        rec = FleetRoundRecord(
            t=t_prev + comp + comm, round=r,
            accuracy=self.global_accuracy(), comm_bytes=comm_bytes,
            comp_time=comp, comm_time=comm, n_participating=n_part,
            n_rejected=n_rejected)
        self.history.append(rec)
        return rec

    def run(self, rounds: int) -> List[FleetRoundRecord]:
        for _ in range(rounds):
            self.run_round()
        return self.history

    def global_accuracy(self) -> float:
        return float(self.acc_fn(self.params, *self.test_data))

    def export_residuals(self):
        return self.state.residuals

    def kappa(self) -> float:
        """Eq. (5) over the whole run."""
        comm = sum(r.comm_time for r in self.history)
        comp = sum(r.comp_time for r in self.history)
        return async_update.communication_efficiency(comm, comp)
