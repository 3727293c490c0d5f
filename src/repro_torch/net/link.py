"""Virtual-time link model: what an upload's bytes cost to move.

Port of `repro.net.link` (numpy, bit-identical draws).  A `LinkProfile`
declares per-node link behaviour as distributions: a lognormal per-node
bandwidth scale on top of the fleet's `NodeProfile` uplink rates, a fixed
propagation latency, exponential per-upload jitter, an MTU-packetized
loss/retransmit model, and an optional shared-uplink contention cap.
`materialize_bandwidth` resolves the per-node rates once per run;
`draw_transfer_batch` samples a batch of uploads' transfer times.

Determinism: every stochastic draw is keyed by ``(seed, node, upload
sequence number)`` through a counter-based SplitMix64 hash stream, so the
k-th upload of node i costs the same virtual time however arrivals bucket
into windows or rounds.  Shared-uplink contention is the one exception:
it depends on how many uploads share the window.  The stream stays in
numpy uint64 arithmetic, exactly as the reference computes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class LinkProfile:
    """Declarative per-upload link behaviour (all defaults = an ideal
    link: transfer time is exactly payload_bytes / node_bandwidth)."""
    bandwidth_sigma: float = 0.0    # lognormal sigma of per-node uplink scale
    latency_s: float = 0.0          # fixed propagation latency per upload
    jitter_s: float = 0.0           # exponential jitter scale per upload
    loss_prob: float = 0.0          # per-packet loss probability
    mtu_bytes: int = 1500           # packet size for the loss model
    shared_uplink_bps: float = 0.0  # >0 => uplink capacity shared by every
                                    # concurrent upload in a window/round

    def validate(self) -> None:
        if self.bandwidth_sigma < 0:
            raise ValueError(f"bandwidth_sigma must be >= 0, got "
                             f"{self.bandwidth_sigma}")
        if self.latency_s < 0 or self.jitter_s < 0:
            raise ValueError("latency_s and jitter_s must be >= 0")
        if not 0.0 <= self.loss_prob < 1.0:
            raise ValueError(f"loss_prob must be in [0, 1), got "
                             f"{self.loss_prob}")
        if self.mtu_bytes < 1:
            raise ValueError(f"mtu_bytes must be >= 1, got {self.mtu_bytes}")
        if self.shared_uplink_bps < 0:
            raise ValueError(f"shared_uplink_bps must be >= 0, got "
                             f"{self.shared_uplink_bps}")


def materialize_bandwidth(base_bps: np.ndarray, sigma: float,
                          seed: int) -> np.ndarray:
    """Per-node effective uplink rates: the fleet profile's bandwidths
    scaled by a lognormal factor exp(N(0, sigma)) — sigma=0 returns the
    profile rates untouched (byte-for-byte the analytic model's).

    Rates are validated strictly positive and finite: a zero/negative/NaN
    uplink would otherwise divide through `draw_transfer_batch` into
    inf/NaN transfer times and silently poison the async arrival clocks.
    """
    base = np.asarray(base_bps, np.float64)
    _require_positive_bw(base, "node bandwidth")
    if sigma <= 0:
        return base.copy()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0xB]))
    out = base * np.exp(rng.normal(0.0, sigma, base.shape[0]))
    _require_positive_bw(out, "materialized bandwidth")
    return out


def _require_positive_bw(bw: np.ndarray, what: str) -> None:
    if bw.size and not (np.isfinite(bw).all() and (bw > 0).all()):
        bad = bw[~(np.isfinite(bw) & (bw > 0))]
        raise ValueError(
            f"{what} must be finite and > 0 (transfer time divides by it); "
            f"got {bad[:4].tolist()}{'...' if bad.size > 4 else ''}")


# -- the counter-based per-upload uniform stream ----------------------------
#
# SplitMix64: a stateless hash from (stream key, draw index) to a uniform
# in (0, 1).  Keying each upload's stream on (seed, node, seq) makes every
# draw independent of batching — draw one upload or ten thousand at once
# and the k-th upload of node i sees the same bits — which is exactly the
# determinism contract `NetSim.draw` needs, and unlike `SeedSequence`
# streams it vectorizes to one numpy expression over (uploads, draws).

_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_GAMMA2 = np.uint64((0x9E3779B97F4A7C15 ** 2) & (2 ** 64 - 1))
# cap on uploads*packets per vectorized geometric-draw block (memory bound)
_CHUNK_DRAWS = 1 << 22


def _mix64(z: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer, elementwise on uint64 arrays (wrapping)."""
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def _unit(h: np.ndarray) -> np.ndarray:
    """uint64 hash -> float64 uniform strictly inside (0, 1) (53 bits,
    half-ulp offset keeps log() finite)."""
    return ((h >> np.uint64(11)).astype(np.float64) + 0.5) * (2.0 ** -53)


def _stream_key(seed: int, nodes: np.ndarray, seqs: np.ndarray) -> np.ndarray:
    """(U,) uint64 per-upload stream keys from (seed, node, seq): each
    component is mixed before combining so structured inputs (consecutive
    node ids, counter seqs) land on unrelated streams."""
    k = _mix64(np.asarray(seqs, np.uint64) + _GAMMA)
    k = _mix64(k ^ _mix64(np.asarray(nodes, np.uint64) + _GAMMA2))
    return _mix64(k ^ np.uint64(int(seed) & (2 ** 64 - 1)))


def draw_transfer_batch(link: LinkProfile, payload_bytes: float,
                        node_bw_bps: np.ndarray, seed: int,
                        nodes: np.ndarray, seqs: np.ndarray,
                        concurrency: int = 1
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batch of uploads' (transfer_s, wire_overhead_bytes, retransmits),
    each (U,), fully vectorized.

    Per upload: transfer = latency + jitter + wire_bytes / effective_bw,
    where wire_bytes = payload + retransmits·MTU — each of the payload's
    ceil(bytes/MTU) packets is resent until it survives loss_prob, the
    per-packet retransmit count drawn geometrically by inverse CDF
    (floor(log u / log loss_prob), so the packet sum is the same
    negative-binomial law the scalar path always modelled) — and the
    effective bandwidth is the node uplink, capped at
    shared_uplink_bps / concurrency when a shared uplink is declared.

    Draw i of upload (seed, node, seq) is hash(key, i): index 0 is the
    jitter draw, indices 1..packets the per-packet loss draws, so results
    are independent of batch composition.  The packet axis is chunked to
    bound peak memory at ~`_CHUNK_DRAWS` doubles.
    """
    nodes = np.asarray(nodes, np.int64)
    seqs = np.asarray(seqs, np.int64)
    u = nodes.size
    retrans = np.zeros(u, np.int64)
    jitter = np.zeros(u, np.float64)
    if u and (link.loss_prob > 0.0 or link.jitter_s > 0.0):
        key = _stream_key(seed, nodes, seqs)
        if link.jitter_s > 0.0:
            jitter = -link.jitter_s * np.log(_unit(_mix64(key)))
        if link.loss_prob > 0.0:
            packets = max(1, -(-int(payload_bytes) // link.mtu_bytes))
            inv_log_loss = 1.0 / np.log(link.loss_prob)
            step = max(1, _CHUNK_DRAWS // u)
            for lo in range(1, packets + 1, step):
                idx = np.arange(lo, min(lo + step, packets + 1),
                                dtype=np.uint64)
                us = _unit(_mix64(key[:, None] + idx[None, :] * _GAMMA))
                retrans += np.floor(
                    np.log(us) * inv_log_loss).astype(np.int64).sum(axis=1)
    overhead = retrans * float(link.mtu_bytes)
    bw = np.asarray(node_bw_bps, np.float64).copy()
    _require_positive_bw(bw, "node bandwidth")
    if link.shared_uplink_bps > 0.0:
        bw = np.minimum(bw, link.shared_uplink_bps / max(1, concurrency))
    transfer = (link.latency_s + jitter
                + (float(payload_bytes) + overhead) / bw)
    return transfer, overhead, retrans


def draw_transfer(link: LinkProfile, payload_bytes: float, node_bw_bps: float,
                  seed: int, node: int, seq: int,
                  concurrency: int = 1) -> Tuple[float, float, int]:
    """One upload's (transfer_s, wire_overhead_bytes, retransmits) — the
    size-1 case of `draw_transfer_batch` (same stream, same bits)."""
    transfer, overhead, retrans = draw_transfer_batch(
        link, payload_bytes, np.asarray([node_bw_bps], np.float64), seed,
        np.asarray([node]), np.asarray([seq]), concurrency=concurrency)
    return float(transfer[0]), float(overhead[0]), int(retrans[0])
