"""Cohort-batched pipeline stages shared by the sync and async engines.

Port of `repro.fleet.stages`:

  local SGD -> delta -> [DGC accumulate+sparsify] -> [ALDP clip+noise]
            -> rebuild node models -> cloud-side accuracy

The upload runs the hand-written fused kernel `kernels.upload_fused` (K1)
on both spec backends: its keep set, residual' and nnz are bitwise the
reference backend's per-leaf DGC split, since both use `leaf_threshold`
and |c| >= thr.  On the reference backend with σ > 0, K1 only splits
(and counts); the clip and the reference's `jax.random.normal` noise
follow in `core.aldp` (the device-side threefry chain).  When a network codec prices the wire and neither sparsify
nor noise runs, the nonzero count is kernel K3 (`count_upload_nnz`).
The unfused chain `sparsify_pallas_cohort` (K4) -> `count_upload_nnz`
(K3) -> `aldp_pallas_cohort` (K5) is the comparator K1 is held against
bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from ..core import accumulator as accum
from ..core import aldp
from ..core.detection import nanpercentile
from ..net.codecs import analytic_upload_bytes


# ---------------------------------------------------------------------------
# stage: node-local minibatch SGD
# ---------------------------------------------------------------------------

def make_local_train(loss_fn, local_steps: int, lr: float, batch_size: int):
    """Cohort-batched local SGD: ``torch.func.vmap`` of ``torch.func.grad``
    over the node axis, one step per loop iteration (the reference scans
    `local_steps` steps of the same update)."""
    grad = torch.func.vmap(torch.func.grad(
        lambda p, x, y: loss_fn(p, {"x": x, "y": y})[0]))

    def local_train(params, x, y, rows: torch.Tensor, idx: torch.Tensor):
        """params stacked (C, ...); x/y the fleet's (N, M, ...) shards;
        rows (C,) node ids; idx (C, local_steps, B) minibatch indices."""
        p = params
        r = rows[:, None]
        for s in range(local_steps):
            g = grad(p, x[r, idx[:, s]], y[r, idx[:, s]])
            p = tree_util.map(lambda a, b: a - lr * b, p, g)
        return p

    return local_train


def batch_indices(k1s: np.ndarray, sizes: np.ndarray, local_steps: int,
                  batch_size: int, device) -> torch.Tensor:
    """The reference's minibatch draws for each node key, on the device."""
    return torch.as_tensor(
        prng.batch_indices(k1s, local_steps, batch_size, sizes),
        device=device)


# ---------------------------------------------------------------------------
# stage: upload pipeline (DGC sparsify -> ALDP), cohort-batched
# ---------------------------------------------------------------------------

def upload_pipeline(cfg, deltas, residuals_c, k2s: np.ndarray,
                    need_nnz: bool = False):
    """[DGC accumulate+sparsify] -> [ALDP clip+noise] over a stacked cohort
    as one `upload_fused_fleet` launch (K1) over the flattened cohort.  The
    per-leaf quantile thresholds and the post-sparsify L2 clip norms stay
    a PyTorch pre-pass here, as they stay a jnp pre-pass in the reference.
    With neither sparsify nor noise there is nothing to compute per
    element: the deltas pass through and ``need_nnz`` counts them with K3
    (`count_upload_nnz`).  The count is post-sparsify, pre-noise: the
    sparse coordinate set the codecs price.  The reference backend with
    noise takes `_upload_reference_noise`.  Returns (uploaded deltas,
    updated cohort residuals, nnz (C,) int32 or None)."""
    from ..kernels import upload_fused as uf

    do_sparsify = cfg.sparsify_ratio < 1.0
    apply_ldp = cfg.sigma > 0.0
    if not (do_sparsify or apply_ldp):
        nnz = count_upload_nnz(deltas) if need_nnz else None
        return deltas, residuals_c, nnz
    if apply_ldp and cfg.backend == "reference":
        return _upload_reference_noise(cfg, deltas, residuals_c, k2s,
                                       need_nnz)
    layout = cohort_layout(deltas)
    flat_d = layout.flatten(deltas)
    thresholds = flat_r = comb = None
    if do_sparsify:
        flat_r = layout.flatten(residuals_c)
        comb = flat_d + flat_r
        thresholds = _leaf_thresholds(layout, comb, cfg.sparsify_ratio)
    seeds = scales = None
    if apply_ldp:
        if do_sparsify:
            thr_elem = uf.spread_thresholds(thresholds, layout.offsets,
                                            layout.total)
            sp = torch.where(comb.abs() >= thr_elem, comb,
                             torch.zeros((), device=comb.device))
        else:
            sp = flat_d
        norms = torch.sqrt(torch.sum(torch.square(sp), dim=1))
        scales = 1.0 / torch.clamp(norms / cfg.clip_s, min=1.0)
        seeds = torch.as_tensor(prng.node_noise_seeds(k2s),
                                device=flat_d.device)
    up, newr, nnz = uf.upload_fused_fleet(
        flat_d, flat_r, thresholds, seeds, scales, cfg.sigma, cfg.clip_s,
        boundaries=layout.offsets, need_nnz=need_nnz)
    deltas = layout.unflatten(up)
    if do_sparsify:
        residuals_c = layout.unflatten(newr)
    return deltas, residuals_c, nnz


def _leaf_thresholds(layout, comb: torch.Tensor, ratio: float
                     ) -> torch.Tensor:
    """(C, L) per-node per-leaf DGC cutoffs of the combined cohort."""
    return torch.stack(
        [accum.leaf_threshold(comb[:, off:off + size], ratio)
         for off, size in zip(layout.offsets, layout.sizes)], dim=1)


def _upload_reference_noise(cfg, deltas, residuals_c, k2s: np.ndarray,
                            need_nnz: bool):
    """The reference backend with σ > 0, as `repro.fleet.stages` runs it:
    the DGC split (K1 with sparsify and nnz only), then the clip by the
    per-leaf global norm and dense `jax.random.normal` noise on every
    coordinate (`core.aldp.perturb_flat`) — the reference's documented
    dense-noise artefact.  The nnz stays post-sparsify, pre-noise."""
    from ..kernels import upload_fused as uf

    layout = cohort_layout(deltas)
    flat = layout.flatten(deltas)
    if cfg.sparsify_ratio < 1.0:
        flat_r = layout.flatten(residuals_c)
        flat, newr, nnz = uf.upload_fused_fleet(
            flat, flat_r, _leaf_thresholds(layout, flat + flat_r,
                                           cfg.sparsify_ratio),
            None, None, 0.0, cfg.clip_s, boundaries=layout.offsets,
            need_nnz=need_nnz)
        residuals_c = layout.unflatten(newr)
    else:
        nnz = count_upload_nnz(deltas) if need_nnz else None
    up, _ = aldp.perturb_flat(flat, k2s, layout.sizes, cfg.sigma,
                              cfg.clip_s)
    return layout.unflatten(up), residuals_c, nnz


def count_upload_nnz(deltas, backend: str = "reference") -> torch.Tensor:
    """Per-node nonzero count of a stacked upload tree — the wire quantity
    the sparse codecs price: the cohort flattened with `cohort_layout`,
    then one K3 launch (`net.codecs.count_nnz`) on either backend (the
    reference's per-leaf sums give the same integers)."""
    from ..net.codecs import count_nnz
    return count_nnz(cohort_layout(deltas).flatten(deltas), backend)


def rebuild_and_evaluate(acc_fn, start_params, deltas, cloud_x, cloud_y):
    """Rebuild every node's uploaded model ω_new = ω_start + Δ and score it
    on the cloud testing dataset (§5.4).  ``start_params`` is the global
    model (no node axis, broadcast) or the stacked dispatched params."""
    broadcast = (tree_util.leaves(deltas)[0].ndim
                 > tree_util.leaves(start_params)[0].ndim)
    if broadcast:
        omegas = tree_util.map(lambda g, d: g[None].to(d.dtype) + d,
                               start_params, deltas)
    else:
        omegas = tree_util.map(lambda g, d: g.to(d.dtype) + d,
                               start_params, deltas)
    accs = torch.func.vmap(acc_fn, in_dims=(0, None, None))(
        omegas, cloud_x, cloud_y)
    return omegas, accs


# ---------------------------------------------------------------------------
# stage: masked detection (Alg. 2 over a partially-valid cohort)
# ---------------------------------------------------------------------------

def detect_masked(accs: torch.Tensor, valid: torch.Tensor, s: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 with padded slots excluded: threshold is the top-s
    percentile of the valid accuracies (`detection.nanpercentile`, the
    reference's compiled arithmetic)."""
    accs = accs.to(torch.float32)
    masked = torch.where(valid, accs, torch.full_like(accs, float("nan")))
    thr = nanpercentile(masked, s)
    mask = (accs > thr) & valid
    mask = torch.where(mask.any(), mask, (accs >= thr) & valid)
    return mask, thr


# ---------------------------------------------------------------------------
# stage: the adversary zoo's delta-level attacks (sybil boosting, the
# adaptive attacker's throttle) and the DDoS flood count for `NetSim.draw`;
# the data-level attacks live in the shards (`data.federated`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttackPlan:
    """Engine-side view of an `api.AttackMix` + the materialized malicious
    ids: which rows are adversarial and how their uploads misbehave."""
    kind: str                       # label_flip|sybil|backdoor|adaptive|ddos
    malicious: np.ndarray           # (N,) bool host-side membership
    sybil_boost: float = 3.0
    adapt_poison_scale: float = 0.5
    ddos_uploads: int = 4

    @classmethod
    def from_spec(cls, attack, n_nodes: int, malicious_ids) -> "AttackPlan":
        mal = np.zeros(int(n_nodes), bool)
        mal[np.asarray(list(malicious_ids), int)] = True
        return cls(kind=attack.kind, malicious=mal,
                   sybil_boost=float(attack.sybil_boost),
                   adapt_poison_scale=float(attack.adapt_poison_scale),
                   ddos_uploads=int(attack.ddos_uploads))

    @property
    def n_malicious(self) -> int:
        return int(self.malicious.sum())

    @property
    def needs_throttle(self) -> bool:
        """Does this attack carry device-side state (`FleetState.throttle`)?"""
        return self.kind == "adaptive"

    @property
    def flood_uploads(self) -> int:
        """Extra concurrent flows the DDoS attack adds to `NetSim.draw`'s
        shared-uplink contention each round or window."""
        return (self.n_malicious * self.ddos_uploads
                if self.kind == "ddos" else 0)

    def mask(self, device=None) -> torch.Tensor:
        """(N,) bool device mask."""
        return torch.as_tensor(self.malicious, device=device)


def scale_node_rows(tree, scale: torch.Tensor):
    """Multiply every leaf's node rows by the (C,) per-node scale."""
    return tree_util.map(
        lambda x: x * scale.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype),
        tree)


def make_delta_attack(plan):
    """The delta-level attack stage, or None when the attack does not
    touch uploads: stage(deltas, mal_c, throttle_c) with ``mal_c`` the
    cohort's malicious mask and ``throttle_c`` the adaptive attacker's
    per-node poison scale (ignored by sybil)."""
    if plan is None or plan.kind not in ("sybil", "adaptive"):
        return None
    if plan.kind == "sybil":
        boost = float(plan.sybil_boost)

        def stage(deltas, mal_c, throttle_c=None):
            one = torch.ones((), device=mal_c.device)
            return scale_node_rows(deltas, torch.where(mal_c, boost * one,
                                                       one))
    else:
        def stage(deltas, mal_c, throttle_c):
            return scale_node_rows(deltas, torch.where(
                mal_c, throttle_c, torch.ones_like(throttle_c)))
    return stage


def adaptive_throttle_update(throttle: torch.Tensor, rejected: torch.Tensor,
                             seen: torch.Tensor, scale: float
                             ) -> torch.Tensor:
    """The detection-aware attacker's control law per participating node:
    caught ⇒ × ``scale``; accepted ⇒ × 1.1, capped at 1.  Non-participants
    keep their state."""
    upd = torch.where(rejected, throttle * float(scale),
                      torch.clamp(throttle * 1.1, max=1.0))
    return torch.where(seen, upd, throttle)


# ---------------------------------------------------------------------------
# cohort flat layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CohortLayout:
    """Flat layout of a stacked cohort tree in the reference's leaf order:
    per-node shapes, sizes and start offsets in the (C, P) f32 view."""
    template: object
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int

    def flatten(self, tree) -> torch.Tensor:
        """Stacked tree with leading cohort axis -> (C, P) f32."""
        return torch.cat([l.reshape(l.shape[0], -1).to(torch.float32)
                          for l in tree_util.leaves(tree)], dim=1)

    def flatten_one(self, tree) -> torch.Tensor:
        """Unbatched tree -> (P,) f32, same leaf order."""
        return torch.cat([l.reshape(-1).to(torch.float32)
                          for l in tree_util.leaves(tree)])

    def unflatten(self, flat: torch.Tensor):
        return tree_util.unflatten_like(self.template, [
            flat[:, o:o + s].reshape((flat.shape[0],) + shape)
            for shape, s, o in zip(self.shapes, self.sizes, self.offsets)])

    def unflatten_one(self, flat: torch.Tensor):
        return tree_util.unflatten_like(self.template, [
            flat[o:o + s].reshape(shape)
            for shape, s, o in zip(self.shapes, self.sizes, self.offsets)])


def cohort_layout(tree) -> CohortLayout:
    """The `CohortLayout` of a stacked tree (leading cohort axis)."""
    leaves = tree_util.leaves(tree)
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    sizes = tuple(int(np.prod(s)) for s in shapes)
    offsets = tuple(int(o) for o in np.concatenate(
        [[0], np.cumsum(sizes)[:-1]]))
    return CohortLayout(tree, shapes, sizes, offsets, int(sum(sizes)))


def flatten_cohort(tree):
    """Stacked tree with leading cohort axis -> ((C, P) flat, unflatten)."""
    layout = cohort_layout(tree)
    return layout.flatten(tree), layout.unflatten


# ---------------------------------------------------------------------------
# the unfused upload chain (K4 -> K3 -> K5), K1's comparator
# ---------------------------------------------------------------------------

def sparsify_pallas_cohort(deltas, residuals, ratio: float):
    """Per-leaf DGC split with the node-batched `sparsify_fleet` kernel
    (K4): the per-leaf quantile threshold of `accumulator.leaf_threshold`,
    one launch per leaf for the whole cohort.  Returns (upload tree,
    residual' tree)."""
    from ..kernels.sparsify import sparsify_fleet

    def one_leaf(d, r):
        c = d.shape[0]
        df = d.reshape(c, -1).to(torch.float32)
        rf = r.reshape(c, -1).to(torch.float32)
        thr = accum.leaf_threshold(df + rf, ratio)
        up, newr = sparsify_fleet(df, rf, thr)
        return up.reshape(d.shape).to(d.dtype), newr.reshape(r.shape)

    pairs = [one_leaf(d, r) for d, r in zip(tree_util.leaves(deltas),
                                            tree_util.leaves(residuals))]
    return (tree_util.unflatten_like(deltas, [p[0] for p in pairs]),
            tree_util.unflatten_like(residuals, [p[1] for p in pairs]))


def aldp_pallas_cohort(deltas, k2s: np.ndarray, sigma: float, clip_s: float):
    """Cohort ALDP with the node-batched `ldp_perturb_fleet` kernel (K5),
    one launch per cohort: whole-delta clip scale per node, noise seeded
    by `prng.node_noise_seeds` of the per-node keys."""
    from ..kernels.ldp_noise import ldp_perturb_fleet

    layout = cohort_layout(deltas)
    flat = layout.flatten(deltas)
    norms = torch.sqrt(torch.sum(torch.square(flat), dim=1))
    scales = 1.0 / torch.clamp(norms / clip_s, min=1.0)
    seeds = torch.as_tensor(prng.node_noise_seeds(k2s), device=flat.device)
    return layout.unflatten(ldp_perturb_fleet(flat, seeds, scales, sigma,
                                              clip_s))


# ---------------------------------------------------------------------------
# construction + analytic wire accounting shared by both engines
# ---------------------------------------------------------------------------

DEFAULT_BANDWIDTH_BPS = 12.5e6      # 100 Mbit/s edge uplink


def init_engine_common(init_params, node_data, test_data, cloud_test,
                       profile, device, mesh=None):
    """Setup both engines share: shards to `FleetData` on the device (on
    a ``mesh``: padded to a shard multiple and cut to this rank's block,
    ``sizes`` kept whole on the host), eval sets to the device, the
    default system profile, the param count.

    Returns (data, n_nodes, test, cloud, profile, n_params)."""
    from .engine import NodeProfile       # deferred: engine imports stages
    from .state import FleetData

    data = (node_data if isinstance(node_data, FleetData)
            else FleetData.from_node_data(
                node_data, device=device if mesh is None else "cpu"))
    n_nodes = data.n_nodes
    if mesh is not None:
        padded = data.pad_to(mesh.padded(n_nodes))
        blk = mesh.put_nodes({"x": padded.x, "y": padded.y})
        data = FleetData(x=blk["x"].to(device), y=blk["y"].to(device),
                         sizes=padded.sizes)
    test = tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in test_data)
    cloud = tuple(torch.as_tensor(np.asarray(a), device=device)
                  for a in cloud_test)
    profile = profile or NodeProfile(
        compute_s=np.ones(n_nodes),
        bandwidth_bps=np.full(n_nodes, DEFAULT_BANDWIDTH_BPS))
    return data, n_nodes, test, cloud, profile, tree_util.size(init_params)


def bytes_per_node(n_params: int, sparsify_ratio: float) -> float:
    """Analytic upload size per node: dense f32 values, or (value, index)
    pairs for a sparsified upload."""
    return analytic_upload_bytes(n_params, sparsify_ratio)
