"""Engine bridge: per-upload transfer times + the NetTrace byte stream.

Port of `repro.net.bridge`.  `NetSim` is what the fleet engines hold when
a `NetworkSpec` enables the network layer.  The handshake per round or
window has two phases, matching the engines' host/device split:

  1. ``draw(nodes)`` — before the window runs: sample each upload's
     virtual transfer time (the codec's nominal payload size + the
     `LinkProfile`'s jitter/loss/contention), which feeds the clocks;
  2. ``commit(draw, nnz)`` — after the device returns the measured
     per-upload nonzero counts: exact encoded byte counts through the
     codec, appended to the `NetTrace`, and — with a tracer enabled — one
     ``net.upload`` instant per upload plus the ``net.*`` counters and
     transfer-time histogram.

``rate_scale`` is the simulation service's traffic-trace throttle (None
outside `sim.SimService`); `export_sim_state`/`restore_sim_state` carry
the upload counters and the trace columns through a checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..obs import SECONDS_EDGES, get_tracer
from .codecs import Codec, get_codec
from .link import LinkProfile, draw_transfer_batch, materialize_bandwidth


@dataclass
class UploadDraw:
    """One batch of pre-flight transfer draws (a window/round's uploads)."""
    nodes: np.ndarray           # (U,) int node ids
    seqs: np.ndarray            # (U,) int per-node upload sequence numbers
    transfer_s: np.ndarray      # (U,) float64 virtual transfer times
    overhead_bytes: np.ndarray  # (U,) float64 retransmitted bytes
    retransmits: np.ndarray     # (U,) int retransmitted packets


@dataclass
class NetTrace:
    """The accounting stream: exact encoded bytes per committed upload."""
    codec: str
    nodes: List[int] = field(default_factory=list)
    seqs: List[int] = field(default_factory=list)
    nnz: List[int] = field(default_factory=list)
    encoded_bytes: List[int] = field(default_factory=list)
    wire_bytes: List[float] = field(default_factory=list)
    transfer_s: List[float] = field(default_factory=list)
    retransmits: List[int] = field(default_factory=list)

    @property
    def n_uploads(self) -> int:
        return len(self.nodes)

    @property
    def total_encoded_bytes(self) -> float:
        return float(np.sum(self.encoded_bytes)) if self.nodes else 0.0

    def summary(self) -> Dict:
        return {
            "codec": self.codec,
            "n_uploads": self.n_uploads,
            "encoded_bytes": self.total_encoded_bytes,
            "wire_bytes": (float(np.sum(self.wire_bytes))
                           if self.nodes else 0.0),
            "transfer_s": (float(np.sum(self.transfer_s))
                           if self.nodes else 0.0),
            "retransmits": int(np.sum(self.retransmits))
            if self.nodes else 0,
        }


class NetSim:
    """Per-fleet network simulator: codec + materialized links + trace.

    Args: codec (a `Codec` or registry name); link (`LinkProfile`);
    bandwidth_bps (N,) per-node base uplink rates, scaled lognormally per
    node at construction; n_params (model size, for the index width);
    sparsify_ratio (sets the nominal nonzero count of the pre-flight
    draws); seed (root of the per-upload PRNG stream); tracer (an
    `obs.Tracer` for the per-upload events and metrics; defaults to the
    process-global one, a no-op unless a run installed one)."""

    def __init__(self, codec, link: LinkProfile, bandwidth_bps: np.ndarray,
                 n_params: int, sparsify_ratio: float = 1.0, seed: int = 0,
                 tracer=None):
        self.codec: Codec = (get_codec(codec) if isinstance(codec, str)
                             else codec)
        link.validate()
        self.link = link
        self.seed = int(seed)
        self.n_params = int(n_params)
        self.eff_bandwidth_bps = materialize_bandwidth(
            bandwidth_bps, link.bandwidth_sigma, seed)
        self.nominal_nnz = (int(n_params) if sparsify_ratio >= 1.0
                            else int(n_params * sparsify_ratio))
        self.nominal_payload_bytes = int(
            np.asarray(self.codec.nbytes(self.nominal_nnz, self.n_params)))
        self._counters = np.zeros(self.eff_bandwidth_bps.shape[0], np.int64)
        self.trace = NetTrace(codec=self.codec.describe())
        self._tracer = tracer
        # per-node rate multiplier in (0, 1], set per round/window by the
        # simulation service's traffic traces; None is the stationary
        # default
        self.rate_scale: Optional[np.ndarray] = None

    @property
    def tracer(self):
        return self._tracer if self._tracer is not None else get_tracer()

    def draw(self, nodes: np.ndarray,
             extra_concurrency: int = 0) -> UploadDraw:
        """Sample transfer times for one batch of concurrent uploads and
        advance each node's upload counter.  Concurrency for the shared-
        uplink cap is the batch size plus ``extra_concurrency``: flood
        flows that contend for the uplink without being model uploads
        (the DDoS attack's, `fleet.stages.AttackPlan.flood_uploads`)."""
        nodes = np.asarray(nodes, np.int64)
        u = nodes.size
        conc = u + max(0, int(extra_concurrency))
        seqs = self._counters[nodes].copy()
        np.add.at(self._counters, nodes, 1)
        link = self.link
        eff_bw = self.eff_bandwidth_bps[nodes]
        if self.rate_scale is not None:
            eff_bw = eff_bw * np.asarray(self.rate_scale,
                                         np.float64)[nodes]
        if link.loss_prob == 0.0 and link.jitter_s == 0.0:
            bw = eff_bw
            if link.shared_uplink_bps > 0.0:
                bw = np.minimum(bw, link.shared_uplink_bps / max(1, conc))
            transfer = (link.latency_s
                        + float(self.nominal_payload_bytes) / bw)
            return UploadDraw(nodes=nodes, seqs=seqs, transfer_s=transfer,
                              overhead_bytes=np.zeros(u),
                              retransmits=np.zeros(u, np.int64))
        transfer, overhead, retrans = draw_transfer_batch(
            link, self.nominal_payload_bytes, eff_bw,
            self.seed, nodes, seqs, concurrency=conc)
        return UploadDraw(nodes=nodes, seqs=seqs, transfer_s=transfer,
                          overhead_bytes=overhead, retransmits=retrans)

    def commit(self, draw: UploadDraw, nnz: np.ndarray,
               ctx: Optional[Dict] = None) -> np.ndarray:
        """Resolve the batch's exact encoded bytes from the measured
        nonzero counts and append every upload to the trace.  Returns the
        (U,) encoded byte counts.  ``ctx`` tags (``{"round": r}`` or
        ``{"window": w}`` from the engines) are merged into each
        ``net.upload`` instant, so trace consumers can key byte
        accounting by record."""
        nnz = np.asarray(nnz, np.int64)
        if nnz.shape != draw.nodes.shape:
            raise ValueError(f"commit: nnz shape {nnz.shape} != draw batch "
                             f"{draw.nodes.shape}")
        enc = np.asarray(self.codec.nbytes(nnz, self.n_params), np.int64)
        t = self.trace
        t.nodes.extend(int(x) for x in draw.nodes)
        t.seqs.extend(int(x) for x in draw.seqs)
        t.nnz.extend(int(x) for x in nnz)
        t.encoded_bytes.extend(int(x) for x in enc)
        t.wire_bytes.extend(float(e + o) for e, o in
                            zip(enc, draw.overhead_bytes))
        t.transfer_s.extend(float(x) for x in draw.transfer_s)
        t.retransmits.extend(int(x) for x in draw.retransmits)
        tr = self.tracer
        if tr.enabled:
            extra = ctx or {}
            for i in range(draw.nodes.size):
                tr.instant("net.upload", node=int(draw.nodes[i]),
                           seq=int(draw.seqs[i]), nnz=int(nnz[i]),
                           encoded_bytes=int(enc[i]),
                           transfer_s=float(draw.transfer_s[i]),
                           retransmits=int(draw.retransmits[i]), **extra)
            m = tr.metrics
            m.counter("net.uploads").inc(draw.nodes.size)
            m.counter("net.encoded_bytes").inc(float(np.sum(enc)))
            m.counter("net.retransmits").inc(
                float(np.sum(draw.retransmits)))
            h = m.histogram("net.transfer_s", SECONDS_EDGES)
            for x in draw.transfer_s:
                h.observe(float(x))
        return enc

    def summary(self) -> Dict:
        return self.trace.summary()

    # -- checkpoint/resume (sim.SimService) ---------------------------------
    _TRACE_COLUMNS = ("nodes", "seqs", "nnz", "encoded_bytes", "wire_bytes",
                      "transfer_s", "retransmits")

    def export_sim_state(self):
        """(counters array, trace columns): what a bit-exact resume needs
        beyond the constructor arguments — the per-node upload counters
        drive the (seed, node, seq) PRNG stream, and the trace columns
        rebuild the byte accounting (JSON floats round-trip exactly)."""
        columns = {name: list(getattr(self.trace, name))
                   for name in self._TRACE_COLUMNS}
        return self._counters.copy(), columns

    def restore_sim_state(self, counters, columns=None) -> None:
        counters = np.asarray(counters, np.int64)
        if counters.shape != self._counters.shape:
            raise ValueError(
                f"NetSim.restore_sim_state: counter shape {counters.shape} "
                f"!= fleet shape {self._counters.shape}")
        self._counters[:] = counters
        if columns is not None:
            for name in self._TRACE_COLUMNS:
                col = getattr(self.trace, name)
                col[:] = columns.get(name, [])


def netsim_from_network(network, bandwidth_bps: np.ndarray, n_params: int,
                        sparsify_ratio: float, seed: int, tracer=None
                        ) -> Optional[NetSim]:
    """A `NetSim` from an `api.NetworkSpec`, or None when the spec keeps
    the analytic model (``codec == "analytic"``)."""
    if network is None or network.codec == "analytic":
        return None
    codec = get_codec(network.codec, value_bits=network.value_bits)
    link = LinkProfile(
        bandwidth_sigma=network.bandwidth_sigma,
        latency_s=network.latency_s, jitter_s=network.jitter_s,
        loss_prob=network.loss_prob, mtu_bytes=network.mtu_bytes,
        shared_uplink_bps=network.shared_uplink_bps)
    return NetSim(codec, link, bandwidth_bps, n_params,
                  sparsify_ratio=sparsify_ratio, seed=seed, tracer=tracer)
