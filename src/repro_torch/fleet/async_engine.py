"""AsyncFleetEngine: the paper's asynchronous scheme, one window at a time.

Port of `repro.fleet.async_engine` for one device.  Per-node virtual
clocks and dispatched models live on the device; each window

  1. selects every pending arrival inside [t0, t0 + window);
  2. runs the shared upload pipeline (local SGD from each node's stale
     dispatched params -> DGC sparsify -> ALDP) for the whole window;
  3. folds the window into the global model in arrival order: a scalar
     control scan on the host (detection ring, staleness, version) emits
     per arrival a gate and the coefficients (a, b) of
     params = gate ? a·params + b·omega : params, and the param fold runs
     as the `kernels.window_fold` kernel on either spec backend (the
     kernel is bitwise the reference's fold);
  4. redispatches each processed node with the model right after its own
     arrival and advances its clock by uplink + compute time.

With a `net.NetSim` attached, each window's uplink seconds are the link
model's draws for the in-window uploads (so the network moves the clocks,
and with them the arrival order and later windows' composition), and the
uploads' measured nonzero counts are priced through the wire codec.

With the auto window (min node compute time) arrivals are handled in the
event loop's global time order, and the masked key chain is consumed as
the reference consumes it.  ``mixing="buffered"`` replaces step 3 by the
FedBuff fold (`buffered_fold`): one threshold for the whole buffer, one
masked (staleness- or trust-weighted) mean mixed once, and every
processed node redispatched with the post-window model.  An
`stages.AttackPlan` scales the sybil and adaptive uploads and floods the
link draws; the trust-weighted defense scales each arrival's mixing
coefficient by its trust weight in the control scan.

With a tracer enabled each window emits a ``window`` span, an
``arrival`` instant per processed upload, a ``detect.verdict`` instant
per cloud evaluation (the Alg. 2 audit: the ring threshold and
occupancy each arrival was judged against, which the host fold control
returns when traced) and the window metrics; with ``stage_timings`` its
stages are timed, each fenced on the card.  Tracing changes no
arithmetic of the fold.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from ..core import async_update, detection
from ..device import resolve
from ..obs import (STALENESS_EDGES, WINDOW_SIZE_EDGES, get_tracer,
                   timed_stage)
from . import stages
from .engine import ClientSampler, FleetConfig, NodeProfile
from .mesh import MeshStateIO
from .state import gather_nodes, init_async_fleet_state


@dataclass
class AsyncFleetConfig(FleetConfig):
    """`FleetConfig` + the asynchronous scheduler knobs."""
    window: Optional[float] = None  # None => min node compute time
    mixing: str = "sequential"      # sequential | buffered (FedBuff)
    staleness_adaptive: bool = False
    staleness_a: float = 0.5
    detect_warmup: int = 4
    detect_window: int = 8


@dataclass
class AsyncWindowRecord:
    t: float
    window: int
    version: int
    accuracy: float
    comm_bytes: float
    comp_time: float
    comm_time: float
    n_processed: int
    n_rejected: int
    max_staleness: int


@dataclass
class FoldControl:
    """The control scan's per-arrival outputs (host arrays)."""
    version: int
    ring: torch.Tensor
    count: int
    v_seq: np.ndarray       # (C,) version after each slot
    rej: np.ndarray         # (C,) rejected by detection
    taus: np.ndarray        # (C,) staleness
    gates: np.ndarray       # (C,) mix this arrival?
    a: np.ndarray           # (C,) f32 coefficient on params
    b: np.ndarray           # (C,) f32 coefficient on omega
    # the detection audit of a traced run (None otherwise): the cohort's
    # accuracies and, for each arrived slot, the ring threshold and
    # occupancy its verdict was judged against
    audit: Optional[dict] = None


def _new_audit(accs: torch.Tensor) -> dict:
    c = accs.shape[0]
    return {"accs": accs.numpy(), "thr": np.full(c, np.nan, np.float32),
            "held": np.zeros(c, np.int32)}


def control_scan(cfg: AsyncFleetConfig, version: int, ring: torch.Tensor,
                 count: int, accs: torch.Tensor, vdisp_c: np.ndarray,
                 arrived: np.ndarray, trust_c=None,
                 need_audit: bool = False) -> FoldControl:
    """The fold's scalar bookkeeping, in arrival order on the host: ring
    pushes, Alg. 2 verdicts, staleness and versions.  With ``trust_c``
    (the cohort's trust rows) each arrival's omega coefficient b is
    scaled by its `detection.trust_weights` weight against the mean of
    the occupied ring slots (its own accuracy pushed), and a = 1 − b.
    Neither rejection nor a coefficient depends on params, so splitting
    them from the param fold is exact.  Each arrived slot is judged as
    `detection.ring_detect` judges it; with ``need_audit`` its threshold
    and occupancy go into ``audit``."""
    accs = accs.detach().to("cpu", torch.float32)
    if trust_c is not None:
        trust_c = trust_c.detach().to("cpu", torch.float32)
    c = accs.shape[0]
    v_seq = np.zeros(c, np.int32)
    rej = np.zeros(c, bool)
    taus = np.zeros(c, np.int32)
    gates = np.zeros(c, bool)
    a = np.full(c, np.float32(cfg.alpha), np.float32)
    b = np.full(c, np.float32(1.0 - cfg.alpha), np.float32)
    width = ring.shape[0]
    audit = _new_audit(accs) if need_audit else None
    for i in range(c):
        if arrived[i]:
            ring, count = detection.ring_push(ring, count, accs[i])
            if cfg.detect or audit is not None:
                thr = detection.ring_threshold(ring, count, cfg.detect_s)
                held = min(count, width)
                if cfg.detect:
                    rej[i] = (held >= cfg.detect_warmup
                              and bool(accs[i] <= thr))
                if audit is not None:
                    audit["thr"][i] = float(thr)
                    audit["held"][i] = held
        taus[i] = version - int(vdisp_c[i])
        if cfg.staleness_adaptive or trust_c is not None:
            w_new = (async_update.staleness_alpha(cfg.alpha, int(taus[i]),
                                                  cfg.staleness_a)
                     if cfg.staleness_adaptive else torch.tensor(b[i]))
            if trust_c is not None:
                occupied = torch.arange(width) < count
                ref = (torch.where(occupied, ring,
                                   torch.zeros_like(ring)).sum()
                       / np.float32(max(min(count, width), 1)))
                w_new = w_new * detection.trust_weights(
                    trust_c[i], accs[i], torch.tensor(bool(arrived[i])),
                    cfg.trust_floor, cfg.uncertainty_scale, ref=ref)
            a[i] = float(torch.ones((), dtype=torch.float32) - w_new)
            b[i] = float(w_new)
        gates[i] = bool(arrived[i]) and not rej[i]
        version += int(gates[i])
        v_seq[i] = version
    return FoldControl(version, ring, count, v_seq, rej, taus, gates, a, b,
                       audit)


def sequential_fold(cfg: AsyncFleetConfig, params, version, ring, count,
                    omegas, accs, vdisp_c, arrived, trust_c=None,
                    need_audit: bool = False):
    """Eq. (6)/mix_stale over arrival order with streaming detection (and
    trust-scaled coefficients with ``trust_c``), the params through K2.
    Returns (params, control, per-arrival snapshots tree)."""
    from ..kernels.window_fold import window_fold_fleet

    ctl = control_scan(cfg, version, ring, count, accs, vdisp_c, arrived,
                       trust_c, need_audit)
    layout = stages.cohort_layout(omegas)
    dev = tree_util.leaves(params)[0].device
    final, seq = window_fold_fleet(
        layout.flatten_one(params), layout.flatten(omegas),
        torch.as_tensor(ctl.gates, device=dev),
        torch.as_tensor(ctl.a, device=dev),
        torch.as_tensor(ctl.b, device=dev))
    return layout.unflatten_one(final), ctl, layout.unflatten(seq)


def buffered_fold(cfg: AsyncFleetConfig, params, version, ring, count,
                  omegas, accs, vdisp_c, arrived, trust_c=None,
                  need_audit: bool = False):
    """FedBuff: one ring push per arrival, one threshold for the whole
    buffer (rejected: held >= warmup and A <= Thr), staleness at mix time,
    then the plain, staleness-weighted ((τ+1)^−a) or trust-weighted
    masked mean mixed once by Eq. (6).  Returns (params, control, None):
    every processed node receives the post-window model and version.
    With ``need_audit`` every arrived slot is audited against the one
    threshold and occupancy."""
    accs_h = accs.detach().to("cpu", torch.float32)
    c = accs_h.shape[0]
    for i in range(c):
        if arrived[i]:
            ring, count = detection.ring_push(ring, count, accs_h[i])
    rej = np.zeros(c, bool)
    audit = _new_audit(accs_h) if need_audit else None
    if cfg.detect or audit is not None:
        thr = detection.ring_threshold(ring, count, cfg.detect_s)
        held = min(count, ring.shape[0])
        if cfg.detect and held >= cfg.detect_warmup:
            rej = arrived & (accs_h <= thr).numpy()
        if audit is not None:
            audit["thr"][arrived] = float(thr)
            audit["held"][arrived] = held
    mask_h = arrived & ~rej
    taus = (version - np.asarray(vdisp_c, np.int64)).astype(np.int32)
    dev = accs.device
    mask = torch.as_tensor(mask_h, device=dev)
    w = None
    if trust_c is not None:
        w = detection.trust_weights(trust_c, accs, mask, cfg.trust_floor,
                                    cfg.uncertainty_scale)
    if cfg.staleness_adaptive:
        sw = detection.staleness_weights(taus, cfg.staleness_a).to(dev)
        w = sw if w is None else w * sw
    omega_mean = (detection.masked_mean(omegas, mask) if w is None
                  else detection.masked_weighted_mean(omegas, mask, w))
    if mask_h.any():
        params = async_update.mix(params, omega_mean, cfg.alpha)
        version += 1
    ctl = FoldControl(version, ring, count, np.full(c, version, np.int32),
                      rej, taus, mask_h, None, None, audit)
    return params, ctl, None


class AsyncFleetEngine(MeshStateIO):
    """Event-driven async FEL over a stacked node fleet, one window per
    step, on one device (``device="cuda"`` by default).  ``sampler``
    models churn: an unavailable node loses its in-window upload (no mix,
    no detection entry) but is redispatched.  ``net`` is an optional
    `net.NetSim`, ``tracer`` an `obs.Tracer` (defaults to the
    process-global one at construction), ``attack`` an optional
    `stages.AttackPlan`."""

    def __init__(self, init_params, loss_fn: Callable, acc_fn: Callable,
                 node_data, test_data, cloud_test, cfg: AsyncFleetConfig,
                 profile: Optional[NodeProfile] = None,
                 sampler: Optional[ClientSampler] = None, net=None,
                 device=None, tracer=None, attack=None):
        self.device = resolve(device)
        self.cfg = cfg
        # the tracer is bound at construction: whether the fold control
        # returns the detection audit is decided here
        self.obs = tracer if tracer is not None else get_tracer()
        self._need_audit = self.obs.enabled
        self.net = net
        self.attack = attack
        self.params = tree_util.map(lambda x: x.to(self.device), init_params)
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        (self.data, self.n_nodes, self.test_data, self.cloud_test,
         self.profile, self.n_params) = stages.init_engine_common(
            self.params, node_data, test_data, cloud_test, profile,
            self.device)
        self.sampler = sampler
        self._bpn = stages.bytes_per_node(self.n_params, cfg.sparsify_ratio)
        # float64 host copies feed window selection and the records; the
        # f32 device copies feed the clock update
        self._comm_s = np.asarray(self._bpn / self.profile.bandwidth_bps,
                                  np.float64)
        self._comp_s = np.asarray(self.profile.compute_s, np.float64)
        self._window_len = (cfg.window if cfg.window is not None
                            else float(self._comp_s.min()))
        if self._window_len <= 0:
            raise ValueError(f"window must be positive, got "
                             f"{self._window_len}")
        self.state = init_async_fleet_state(
            self.params, self.n_nodes, prng.PRNGKey(cfg.seed),
            first_arrival=self._comp_s, detect_window=cfg.detect_window,
            trust=cfg.trust_on,
            throttle=attack is not None and attack.needs_throttle)
        self._window_idx = 0
        self.history: List[AsyncWindowRecord] = []
        self._window_fn = self._build_window()

    # -- one arrival window ---------------------------------------------------
    def _build_window(self):
        cfg = self.cfg
        acc_fn = self.acc_fn
        cloud_x, cloud_y = self.cloud_test
        local_train = stages.make_local_train(self.loss_fn, cfg.local_steps,
                                              cfg.lr, cfg.batch_size)
        comp_s = torch.as_tensor(self._comp_s.astype(np.float32),
                                 device=self.device)
        data, dev = self.data, self.device
        need_nnz = self.net is not None     # byte-accurate pricing only
        fold = (sequential_fold if cfg.mixing == "sequential"
                else buffered_fold)
        attack_stage = stages.make_delta_attack(self.attack)
        mal_full = (self.attack.mask(dev) if attack_stage is not None
                    else None)
        adapt_scale = self.attack.adapt_poison_scale if self.attack else 1.0
        need_audit = self._need_audit

        def window_fn(params, state, order, proc, avail, up_s):
            """order: node ids sorted by (arrival, id), truncated to the
            power-of-two bucket; proc: in-window flags; avail: churn mask;
            up_s: per-slot uplink seconds (f32)."""
            order_t = torch.as_tensor(order, dtype=torch.int64, device=dev)
            t_arr = state.next_arrival.index_select(0, order_t)
            vdisp_c = state.dispatched_version.index_select(
                0, order_t).cpu().numpy()
            disp_c = gather_nodes(state.dispatched, order_t)
            res_c = gather_nodes(state.residuals, order_t)
            if cfg.key_mode == "sequential":
                chain_key, k1s, k2s = prng.chain_node_keys_masked(
                    state.chain_key, proc)
            else:
                chain_key, k1s, k2s = prng.parallel_node_keys(
                    state.chain_key, order.shape[0])
            bidx = stages.batch_indices(k1s, data.sizes[order],
                                        cfg.local_steps, cfg.batch_size, dev)
            local = local_train(disp_c, data.x, data.y, order_t, bidx)
            deltas = tree_util.map(lambda l, d: l - d.to(l.dtype), local,
                                   disp_c)
            thr_c = (state.throttle.index_select(0, order_t)
                     if state.throttle is not None else None)
            if attack_stage is not None:
                deltas = attack_stage(
                    deltas, mal_full.index_select(0, order_t), thr_c)
            deltas, res_c, nnz = stages.upload_pipeline(
                cfg, deltas, res_c, k2s, need_nnz=need_nnz)
            if need_nnz:    # lands with the accuracies the control scan
                nnz = nnz.to("cpu", non_blocking=True)      # brings back
            omegas, accs = stages.rebuild_and_evaluate(
                acc_fn, disp_c, deltas, cloud_x, cloud_y)

            arrived = proc & avail
            trust_c = (state.trust.index_select(0, order_t)
                       if state.trust is not None else None)
            params, ctl, p_seq = fold(
                cfg, params, state.version, state.acc_ring, state.acc_count,
                omegas, accs, vdisp_c, arrived, trust_c, need_audit)

            # redispatch the processed slots (in place): the model right
            # after their own arrival (buffered: the post-window model),
            # its version, a fresh clock
            sel = torch.as_tensor(np.flatnonzero(proc), device=dev)
            nodes = order_t[sel]
            if p_seq is None:
                tree_util.map(lambda f, p: f.index_copy_(
                    0, nodes, p[None].expand((nodes.shape[0],)
                                             + tuple(p.shape))),
                    state.dispatched, params)
            else:
                tree_util.map(lambda f, p: f.index_copy_(0, nodes, p[sel]),
                              state.dispatched, p_seq)
            tree_util.map(lambda f, p: f.index_copy_(0, nodes, p[sel]),
                          state.residuals, res_c)
            state.dispatched_version.index_copy_(
                0, nodes, torch.as_tensor(ctl.v_seq, device=dev)[sel])
            t_next = (t_arr + torch.as_tensor(up_s, device=dev)
                      + comp_s.index_select(0, order_t))
            state.next_arrival.index_copy_(0, nodes, t_next[sel])
            # trust EWMA and the adaptive throttle from this window's
            # verdicts (only arrived slots were judged; the others keep
            # their rows)
            if trust_c is not None or thr_c is not None:
                arr_t = torch.as_tensor(arrived, device=dev)
                rej_t = torch.as_tensor(ctl.rej, device=dev) & arr_t
            if trust_c is not None:
                t_new = detection.trust_update(trust_c, arr_t & ~rej_t,
                                               arr_t, cfg.trust_eta)
                state.trust.index_copy_(0, nodes, t_new[sel])
            if thr_c is not None:
                th_new = stages.adaptive_throttle_update(
                    thr_c, rej_t, arr_t, adapt_scale)
                state.throttle.index_copy_(0, nodes, th_new[sel])
            new_state = dataclasses.replace(
                state, chain_key=chain_key, version=ctl.version,
                acc_ring=ctl.ring, acc_count=ctl.count)
            metrics = {
                "n_rejected": int((ctl.rej & arrived).sum()),
                "max_staleness": int(np.where(arrived, ctl.taus, 0).max())}
            if need_nnz:
                metrics["nnz"] = nnz.numpy()
            if ctl.audit is not None:
                metrics["audit"] = dict(ctl.audit, rej=ctl.rej,
                                        taus=ctl.taus)
            return params, new_state, metrics

        return window_fn

    def select_window(self, max_arrivals: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(order, proc): node ids sorted by (arrival, id) and in-window
        flags, truncated to the smallest power-of-two bucket (floored at
        16) that covers the in-window arrivals."""
        na = self.state.next_arrival.cpu().numpy().astype(np.float64)
        order = np.lexsort((np.arange(self.n_nodes), na))
        proc = na[order] < na[order[0]] + self._window_len
        if max_arrivals is not None:
            proc &= np.cumsum(proc) <= max_arrivals
        c = 16
        while c < int(proc.sum()):
            c *= 2
        c = min(c, self.n_nodes)
        return order[:c], proc[:c]

    def run_window(self, max_arrivals: Optional[int] = None,
                   evaluate: bool = True) -> AsyncWindowRecord:
        """Process one arrival window (``evaluate=False`` records NaN
        instead of the global test accuracy)."""
        tr = self.obs
        w = self._window_idx
        span = tr.span("window", window=w)
        span.__enter__()
        with timed_stage(tr, "window.select", window=w):
            order, proc = self.select_window(max_arrivals)
        t_arr = self.state.next_arrival.cpu().numpy().astype(
            np.float64)[order]
        if self.sampler is not None:
            idx_s, up = self.sampler.cohort(w, self.n_nodes)
            mask = np.zeros(self.n_nodes, bool)
            mask[np.asarray(idx_s)[np.asarray(up, bool)]] = True
            avail = mask[order]
        else:
            avail = np.ones(order.size, bool)
        sel = order[proc]
        draw = None
        if self.net is not None:
            # one link draw per in-window upload, in arrival order; the
            # other slots never scatter a clock
            flood = self.attack.flood_uploads if self.attack else 0
            with timed_stage(tr, "net.draw", window=w):
                draw = self.net.draw(sel, extra_concurrency=flood)
            up_host = np.zeros(order.size, np.float64)
            up_host[proc] = draw.transfer_s
        else:
            up_host = self._comm_s[order]
        with timed_stage(tr, "window.device", window=w) as stage:
            self.params, self.state, m = self._window_fn(
                self.params, self.state, order, proc, avail,
                up_host.astype(np.float32))
            stage.fence((self.params, self.state.next_arrival))
        self._window_idx = w + 1
        if self.net is not None:
            with timed_stage(tr, "net.commit", window=w):
                enc = self.net.commit(draw, m["nnz"][proc],
                                      ctx={"window": w})
            uplink = draw.transfer_s
            comm_bytes = float(enc.sum())
        else:
            uplink = self._comm_s[sel]
            comm_bytes = float(self._bpn * sel.size)
        t_arrive = t_arr[proc] + uplink
        if evaluate:
            with timed_stage(tr, "window.evaluate", window=w):
                accuracy = self.global_accuracy()
        else:
            accuracy = float("nan")
        rec = AsyncWindowRecord(
            t=float(t_arrive.max()) if sel.size else 0.0,
            window=w, version=int(self.state.version),
            accuracy=accuracy,
            comm_bytes=comm_bytes,
            comp_time=float(self._comp_s[sel].sum()),
            comm_time=float(uplink.sum()),
            n_processed=int(sel.size), n_rejected=m["n_rejected"],
            max_staleness=m["max_staleness"])
        self.history.append(rec)
        if tr.enabled:
            self._emit_window_events(rec, sel, proc, avail, t_arrive, m)
        span.set(n_processed=rec.n_processed, n_rejected=rec.n_rejected,
                 version=rec.version)
        span.set_virtual(float(t_arr[0]) if t_arr.size else 0.0, rec.t)
        span.__exit__(None, None, None)
        return rec

    def _emit_window_events(self, rec: AsyncWindowRecord, sel, proc, avail,
                            t_arrive, m) -> None:
        """One window's trace: arrival instants (every processed upload),
        a `detect.verdict` instant per cloud evaluation (the Alg. 2 audit
        log — accuracy, ring threshold/occupancy, verdict, staleness), and
        the aggregated window metrics.  Every array is already on the
        host."""
        tr = self.obs
        arrived = avail[proc]
        aud = m.get("audit")
        if aud is not None:
            accs = aud["accs"][proc]
            rej = aud["rej"][proc]
            taus = aud["taus"][proc]
            thr = aud["thr"][proc]
            held = aud["held"][proc]
        for i in range(sel.size):
            t_i = float(t_arrive[i])
            node = int(sel[i])
            tr.instant("arrival", virt_t=t_i, node=node, window=rec.window,
                       arrived=bool(arrived[i]))
            if aud is not None and arrived[i]:
                tr.instant(
                    "detect.verdict", virt_t=t_i, node=node,
                    window=rec.window, accuracy=float(accs[i]),
                    threshold=float(thr[i]), ring_held=int(held[i]),
                    rejected=bool(rej[i]), tau=int(taus[i]),
                    detect=bool(self.cfg.detect))
        mx = tr.metrics
        mx.histogram("window.size", WINDOW_SIZE_EDGES).observe(
            rec.n_processed)
        mx.histogram("window.max_staleness", STALENESS_EDGES).observe(
            rec.max_staleness)
        mx.counter("window.arrivals").inc(rec.n_processed)
        mx.counter("window.rejected").inc(rec.n_rejected)
        mx.counter("window.comm_bytes").inc(rec.comm_bytes)
        mx.gauge("model.version").set(rec.version)

    def run(self, windows: int) -> List[AsyncWindowRecord]:
        for _ in range(windows):
            self.run_window()
        return self.history

    def global_accuracy(self) -> float:
        return float(self.acc_fn(self.params, *self.test_data))

    def kappa(self) -> float:
        """Eq. (5) over the whole run (per-arrival totals)."""
        comm = sum(r.comm_time for r in self.history)
        comp = sum(r.comp_time for r in self.history)
        return async_update.communication_efficiency(comm, comp)
