"""The data-level attacks of the adversary zoo — paper §3.3.

Port of `repro.core.attacks.flip_labels` and `stamp_trigger` (numpy:
they poison the host-side shards before any tensor exists).  The
engine-side attacks (sybil, adaptive, ddos) are not ported yet."""
from __future__ import annotations

import numpy as np


def flip_labels(labels: np.ndarray, src: int, dst: int) -> np.ndarray:
    """Change every label `src` to `dst` (the paper's attack)."""
    labels = np.asarray(labels)
    return np.where(labels == src, dst, labels).astype(labels.dtype)


def stamp_trigger(x: np.ndarray, size: int = 2,
                  value: float = 1.0) -> np.ndarray:
    """Stamp a ``size``×``size`` patch of ``value`` into the top-left
    corner of every image in ``x`` ((..., H, W, C)); returns a copy."""
    out = np.array(x, copy=True)
    out[..., :size, :size, :] = value
    return out
