"""Federated data assembly — a numpy copy of `repro.data.federated`.

Per-node shards + the data-level adversaries, bit-identical to the
reference for the same seed.

`make_federated_image_data` builds the fleet's shards and poisons the
malicious ones according to the attack kind:

  * ``label_flip`` / ``adaptive`` — the paper's src->dst label flip
    (adaptive differs only engine-side, via the detection-aware throttle);
  * ``sybil``    — every sybil trains an identical copy of the first
    sybil's flipped shard (colluding clones push the same poisoned
    direction);
  * ``backdoor`` — a ``trigger_size``² corner patch of ``trigger_value``
    stamped on ``trigger_frac`` of each malicious shard, labels rewritten
    to ``trigger_label`` (clean-task accuracy barely moves);
  * ``ddos``     — shards stay clean: the attack lives entirely in the
    transport layer.

Malicious placement is seeded-random by request (``placement="random"``,
set-based membership, reproducible per seed) or the legacy first-k nodes
(``placement="first"``, the default here for byte-compatibility with
existing direct callers).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.attacks import flip_labels, stamp_trigger
from .synthetic import make_image_dataset, partition_dirichlet, partition_iid

ATTACK_KINDS = ("label_flip", "sybil", "backdoor", "adaptive", "ddos")


def select_malicious(seed: int, n_nodes: int, n_malicious: int,
                     placement: str = "random") -> List[int]:
    """The malicious node ids: a seeded draw without replacement
    (``"random"``) or the legacy first-k (``"first"``).  Sorted, so
    membership tests and shard assembly are order-stable."""
    n_malicious = max(0, min(int(n_malicious), int(n_nodes)))
    if n_malicious == 0:
        return []
    if placement == "first":
        return list(range(n_malicious))
    if placement != "random":
        raise ValueError(f"placement must be 'random' or 'first', got "
                         f"{placement!r}")
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(n_nodes), 0xAD]))
    ids = rng.choice(n_nodes, size=n_malicious, replace=False)
    return sorted(int(i) for i in ids)


def _poison_backdoor(x: np.ndarray, y: np.ndarray, *, rng, frac: float,
                     label: int, size: int, value: float):
    """Trigger-stamp a seeded ``frac`` of the shard: corner patch +
    relabel."""
    n = y.shape[0]
    k = max(1, int(round(frac * n))) if n else 0
    if k == 0:
        return x, y
    idx = rng.choice(n, size=k, replace=False)
    x = x.copy()
    y = y.copy()
    x[idx] = stamp_trigger(x[idx], size=size, value=value)
    y[idx] = label
    return x, y


def make_federated_image_data(
        seed: int, n_nodes: int, n_malicious: int, *,
        n_train: int = 4000, n_test: int = 1000, n_cloud_test: int = 500,
        hw: Tuple[int, int] = (28, 28), ch: int = 1, n_classes: int = 10,
        flip_src: int = 1, flip_dst: int = 7, iid: bool = True,
        dirichlet_alpha: float = 0.5, attack_kind: str = "label_flip",
        placement: str = "first", trigger_frac: float = 0.5,
        trigger_label: int = 0, trigger_size: int = 2,
        trigger_value: float = 1.0):
    """Returns (node_data, test, cloud_test, malicious_ids)."""
    if attack_kind not in ATTACK_KINDS:
        raise ValueError(f"attack_kind {attack_kind!r} not in {ATTACK_KINDS}")
    x, y = make_image_dataset(seed, n_train + n_test + n_cloud_test,
                              hw=hw, ch=ch, n_classes=n_classes)
    x_tr, y_tr = x[:n_train], y[:n_train]
    x_te, y_te = x[n_train:n_train + n_test], y[n_train:n_train + n_test]
    x_ct, y_ct = x[n_train + n_test:], y[n_train + n_test:]

    if iid:
        parts = partition_iid(n_train, n_nodes, seed)
    else:
        parts = partition_dirichlet(y_tr, n_nodes, dirichlet_alpha, seed)

    malicious = select_malicious(seed, n_nodes, n_malicious,
                                 placement=placement)
    mal_set = frozenset(malicious)
    node_data = []
    for node, idx in enumerate(parts):
        xn, yn = x_tr[idx], y_tr[idx]
        if node in mal_set and attack_kind != "ddos":
            if attack_kind == "backdoor":
                rng = np.random.default_rng(
                    np.random.SeedSequence([int(seed), int(node), 0xBD]))
                xn, yn = _poison_backdoor(
                    xn, yn, rng=rng, frac=trigger_frac, label=trigger_label,
                    size=trigger_size, value=trigger_value)
            else:
                yn = np.asarray(flip_labels(yn, flip_src, flip_dst))
        node_data.append((xn, yn))
    if attack_kind == "sybil" and malicious:
        # colluding clones: identical shards => identical poisoned deltas
        x0, y0 = node_data[malicious[0]]
        for m in malicious[1:]:
            node_data[m] = (x0.copy(), y0.copy())
    return node_data, (x_te, y_te), (x_ct, y_ct), malicious
