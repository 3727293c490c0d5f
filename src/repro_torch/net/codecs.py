"""Wire codecs: a sparsified/noised update as an actual byte stream.

Port of `repro.net.codecs` (numpy, byte-identical payloads).  A `Codec`
turns a flat update vector into a real byte payload (`encode`), inverts
it (`decode`: exact for the f32 codecs, within scale/2 per element for
the quantized variant), and predicts the payload size from the nonzero
count alone (`nbytes`), the fast path the engines use per upload.

Registry (`get_codec`):

  * ``dense_f32``       — every value as little-endian f32;
  * ``sparse_coo``      — u32 count header + u32 index / f32 value pairs;
  * ``sparse_bitpack``  — u32 count header + indices bit-packed to
                          ceil(log2(P)) bits each + values as f32, or
                          quantized to ``value_bits`` ∈ {8, 16} (f32 scale
                          header, |error| ≤ scale/2 per element).

Node-batched accounting (`batched_encoded_bytes`) counts the nonzeros of
a stacked (K, P) cohort with `count_nnz` — kernel K3
(`kernels.wire_bytes.nnz_fleet`) on CUDA tensors — and maps the counts
through `Codec.nbytes`.  `analytic_upload_bytes` is the pre-network
estimate the engines keep when no codec is configured.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Union

import numpy as np
import torch

CODEC_NAMES = ("dense_f32", "sparse_coo", "sparse_bitpack")


def analytic_upload_bytes(n_params: int, ratio: float,
                          bytes_per_value: int = 4,
                          bytes_per_index: int = 4) -> int:
    """Dense f32 values, or (value, index) pairs for a sparsified upload."""
    if ratio >= 1.0:
        return int(n_params) * bytes_per_value
    return int(n_params * ratio) * (bytes_per_value + bytes_per_index)


def index_bits(n_params: int) -> int:
    """Bits needed to address a coordinate in [0, n_params)."""
    if n_params < 1:
        raise ValueError(f"n_params must be >= 1, got {n_params}")
    return max(1, int(n_params - 1).bit_length())


# ---------------------------------------------------------------------------
# bit packing (little-endian bit order throughout)
# ---------------------------------------------------------------------------

def _pack_bits(values: np.ndarray, bits: int) -> bytes:
    """Pack each value into ``bits`` little-endian bits, into the minimal
    whole-byte buffer."""
    if values.size == 0:
        return b""
    v = values.astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    mat = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(mat.reshape(-1), bitorder="little").tobytes()


def _unpack_bits(buf: bytes, bits: int, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros(0, np.int64)
    raw = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    mat = raw[:count * bits].reshape(count, bits).astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    return (mat << shifts).sum(axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# messages + codecs
# ---------------------------------------------------------------------------

@dataclass
class WireMessage:
    """One encoded upload: the actual payload plus decode metadata."""
    codec: str
    n_params: int
    payload: bytes
    meta: Dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return len(self.payload)


class Codec:
    """encode/decode + closed-form payload size from the nonzero count."""

    name = "base"

    def encode(self, u: np.ndarray) -> WireMessage:
        raise NotImplementedError

    def decode(self, msg: WireMessage) -> np.ndarray:
        raise NotImplementedError

    def nbytes(self, nnz: Union[int, np.ndarray], n_params: int):
        """Payload bytes for an upload with ``nnz`` nonzeros (vectorized
        over ``nnz`` arrays); equals ``len(encode(u).payload)``."""
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class DenseF32(Codec):
    """Every coordinate as little-endian f32 — the no-compression wire."""

    name = "dense_f32"

    def encode(self, u: np.ndarray) -> WireMessage:
        u = np.asarray(u, np.float32).reshape(-1)
        return WireMessage(self.name, u.size, u.astype("<f4").tobytes())

    def decode(self, msg: WireMessage) -> np.ndarray:
        return np.frombuffer(msg.payload, "<f4").astype(np.float32)

    def nbytes(self, nnz, n_params: int):
        return np.asarray(nnz, np.int64) * 0 + 4 * int(n_params)


class SparseCoo(Codec):
    """u32 count header + (u32 index, f32 value) pairs."""

    name = "sparse_coo"

    def encode(self, u: np.ndarray) -> WireMessage:
        u = np.asarray(u, np.float32).reshape(-1)
        idx = np.flatnonzero(u)
        payload = (struct.pack("<I", idx.size)
                   + idx.astype("<u4").tobytes()
                   + u[idx].astype("<f4").tobytes())
        return WireMessage(self.name, u.size, payload)

    def decode(self, msg: WireMessage) -> np.ndarray:
        (nnz,) = struct.unpack_from("<I", msg.payload, 0)
        idx = np.frombuffer(msg.payload, "<u4", count=nnz, offset=4)
        vals = np.frombuffer(msg.payload, "<f4", count=nnz,
                             offset=4 + 4 * nnz)
        out = np.zeros(msg.n_params, np.float32)
        out[idx.astype(np.int64)] = vals
        return out

    def nbytes(self, nnz, n_params: int):
        return 4 + 8 * np.asarray(nnz, np.int64)


class SparseBitpack(Codec):
    """u32 count header + bit-packed indices (ceil(log2(P)) bits each) +
    values as f32 (exact) or symmetric-scale-quantized ints
    (``value_bits`` ∈ {8, 16}; f32 scale header; |error| ≤ scale/2)."""

    VALUE_BITS = (8, 16, 32)

    def __init__(self, value_bits: int = 32):
        if value_bits not in self.VALUE_BITS:
            raise ValueError(f"sparse_bitpack value_bits must be one of "
                             f"{self.VALUE_BITS}, got {value_bits}")
        self.value_bits = int(value_bits)

    name = "sparse_bitpack"

    def describe(self) -> str:
        return (self.name if self.value_bits == 32
                else f"{self.name}_q{self.value_bits}")

    def encode(self, u: np.ndarray) -> WireMessage:
        u = np.asarray(u, np.float32).reshape(-1)
        idx = np.flatnonzero(u)
        vals = u[idx]
        bits = index_bits(u.size)
        payload = struct.pack("<I", idx.size)
        meta: Dict = {"nnz": int(idx.size)}
        if self.value_bits == 32:
            payload += _pack_bits(idx, bits) + vals.astype("<f4").tobytes()
        else:
            qmax = (1 << (self.value_bits - 1)) - 1
            m = float(np.abs(vals).max()) if vals.size else 0.0
            scale = m / qmax if m > 0 else 1.0
            q = np.clip(np.round(vals.astype(np.float64) / scale),
                        -qmax, qmax)
            dt = "<i1" if self.value_bits == 8 else "<i2"
            payload += (struct.pack("<f", scale) + _pack_bits(idx, bits)
                        + q.astype(dt).tobytes())
            meta["scale"] = scale
        return WireMessage(self.describe(), u.size, payload, meta)

    def decode(self, msg: WireMessage) -> np.ndarray:
        (nnz,) = struct.unpack_from("<I", msg.payload, 0)
        off = 4
        scale = 1.0
        if self.value_bits < 32:
            (scale,) = struct.unpack_from("<f", msg.payload, off)
            off += 4
        bits = index_bits(msg.n_params)
        n_idx_bytes = (nnz * bits + 7) // 8
        idx = _unpack_bits(msg.payload[off:off + n_idx_bytes], bits, nnz)
        off += n_idx_bytes
        if self.value_bits == 32:
            vals = np.frombuffer(msg.payload, "<f4", count=nnz, offset=off)
        else:
            dt = "<i1" if self.value_bits == 8 else "<i2"
            q = np.frombuffer(msg.payload, dt, count=nnz, offset=off)
            vals = (q.astype(np.float64) * scale).astype(np.float32)
        out = np.zeros(msg.n_params, np.float32)
        out[idx] = vals
        return out

    def nbytes(self, nnz, n_params: int):
        nnz = np.asarray(nnz, np.int64)
        bits = index_bits(n_params)
        out = 4 + (nnz * bits + 7) // 8 + nnz * (self.value_bits // 8)
        if self.value_bits < 32:
            out = out + 4                   # the f32 quantization scale
        return out


def get_codec(name: str, value_bits: int = 32) -> Codec:
    """Codec registry lookup; ``value_bits`` selects the quantized-value
    variant of ``sparse_bitpack``."""
    if name == "dense_f32":
        codec: Codec = DenseF32()
    elif name == "sparse_coo":
        codec = SparseCoo()
    elif name == "sparse_bitpack":
        return SparseBitpack(value_bits)
    else:
        raise ValueError(f"unknown codec {name!r}; have {CODEC_NAMES}")
    if value_bits != 32:
        raise ValueError(f"value_bits={value_bits} is a sparse_bitpack "
                         f"variant; codec {name!r} stores f32 values")
    return codec


# ---------------------------------------------------------------------------
# node-batched accounting: stacked cohort -> per-node encoded bytes
# ---------------------------------------------------------------------------

def count_nnz(flat, backend: str = "reference") -> torch.Tensor:
    """Per-node nonzero counts of a stacked (K, P) cohort of flat updates
    — the quantity sparse codecs encode.  Either backend name runs kernel
    K3 (`kernels.wire_bytes.nnz_fleet`): on a CUDA tensor it launches, on
    a CPU tensor (or a numpy array) it runs its plain version.  The
    reference's two backends give the same integers.  Returns (K,) int32
    on ``flat``'s device."""
    from ..kernels.wire_bytes import nnz_fleet

    if backend not in ("reference", "pallas"):
        raise ValueError(f"count_nnz: unknown backend {backend!r}")
    return nnz_fleet(torch.as_tensor(flat))


def batched_encoded_bytes(flat, codec: Codec,
                          backend: str = "reference") -> np.ndarray:
    """Encoded payload size of every row of a stacked (K, P) cohort,
    without materializing any payload: nonzero count -> closed-form
    `Codec.nbytes`.  Equals ``len(codec.encode(row).payload)`` per row."""
    flat = torch.as_tensor(flat)
    nnz = count_nnz(flat, backend).cpu().numpy()
    return np.asarray(codec.nbytes(nnz, int(flat.shape[-1])), np.int64)
