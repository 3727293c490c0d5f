"""Synthetic datasets — a numpy copy of `repro.data.synthetic`.

`make_image_dataset` builds an MNIST/CIFAR-shaped classification problem:
each class has a smooth random prototype image; samples are
prototype + Gaussian noise.  `make_token_dataset` builds an order-2 Markov
language-modelling task for the model zoo.  Same generator calls in the
same order as the reference, so the arrays are bit-identical for the same
seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth(rng: np.random.Generator, hw: Tuple[int, int], ch: int,
            k: int = 5) -> np.ndarray:
    img = rng.normal(size=(hw[0] + k - 1, hw[1] + k - 1, ch))
    kern = np.ones((k, k)) / (k * k)
    out = np.zeros((hw[0], hw[1], ch))
    for c in range(ch):
        for i in range(hw[0]):
            for j in range(hw[1]):
                out[i, j, c] = (img[i:i + k, j:j + k, c] * kern).sum()
    return out


def make_image_dataset(seed: int, n: int, hw: Tuple[int, int] = (28, 28),
                       ch: int = 1, n_classes: int = 10,
                       noise: float = 0.35):
    """Returns (x (n,H,W,C) float32 in [0,1], y (n,) int32)."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth(rng, hw, ch) for _ in range(n_classes)])
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-9)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0, noise, size=(n, hw[0], hw[1], ch))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return x, y


def make_token_dataset(seed: int, n_seq: int, seq_len: int, vocab: int):
    """Order-2 Markov chain over the vocab; returns tokens (n,S+1) int32."""
    rng = np.random.default_rng(seed)
    # sparse transition structure: each (a) maps to a few likely successors
    n_succ = min(4, vocab)
    succ = rng.integers(0, vocab, size=(vocab, n_succ))
    seqs = np.zeros((n_seq, seq_len + 1), dtype=np.int32)
    state = rng.integers(0, vocab, size=n_seq)
    for t in range(seq_len + 1):
        seqs[:, t] = state
        choice = rng.integers(0, n_succ, size=n_seq)
        jump = rng.random(n_seq) < 0.1
        state = np.where(jump, rng.integers(0, vocab, size=n_seq),
                         succ[state, choice])
    return seqs


def partition_iid(n: int, n_nodes: int, seed: int = 0):
    """Random equal split; returns list of index arrays."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return np.array_split(perm, n_nodes)


def partition_dirichlet(labels: np.ndarray, n_nodes: int, alpha: float = 0.5,
                        seed: int = 0):
    """Non-IID split: per-class Dirichlet allocation across nodes."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_node = [[] for _ in range(n_nodes)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_nodes)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for node, part in enumerate(np.split(idx, cuts)):
            idx_by_node[node].append(part)
    return [np.concatenate(parts) for parts in idx_by_node]
