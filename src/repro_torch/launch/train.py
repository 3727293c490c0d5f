"""End-to-end training launcher.

Port of `repro.launch.train`, with the same flags plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain PyTorch path).  Trains
any ``--arch`` (the smoke variant by default, ``--full`` for the
published widths) in either mode:

  fed   — the paper's ALDPFL round: local steps -> ALDP -> detection -> α-mix
  plain — the synchronous baseline (SFL)

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --mode fed --rounds 20 --nodes 4 --local-steps 2

Batches are the reference's numpy draws from one ``default_rng(0)``;
params come from a `torch.Generator` seeded 0 (the draws differ from
`jax.random`'s); the round keys chain from ``prng.PRNGKey(1)`` as the
reference's do.  ``--ckpt`` writes the final params through
`repro_torch.checkpointing` (a file the reference loads too).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from .. import prng
from .. import tree as tree_util
from ..checkpointing import save_checkpoint
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.fed_step import FedStepConfig
from ..data.synthetic import make_token_dataset
from ..device import resolve
from ..models import init_params, loss_fn
from .serve import _sync
from .steps import make_step


def make_batches(cfg, tokens: np.ndarray, lead_shape, seq: int, rng,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """Sample token windows into the requested leading shape, with the
    vlm family's patches or the audio family's frames after them, as the
    reference draws them."""
    lead_shape = tuple(lead_shape)
    n_seq = int(np.prod(lead_shape))
    idx = rng.integers(0, tokens.shape[0], n_seq)
    batch = {"tokens": tokens[idx, :seq].reshape(lead_shape + (seq,)),
             "targets": tokens[idx, 1:seq + 1].reshape(lead_shape + (seq,))}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            0, 1, lead_shape + (cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            0, 1, lead_shape + (cfg.n_audio_frames, cfg.d_model)).astype(
                np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--mode", default="fed", choices=("fed", "plain"))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2, help="per node per step")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--sigma", type=float, default=1e-3)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--no-detect", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(attn_chunk=min(cfg.attn_chunk, args.seq))
    rng = np.random.default_rng(0)
    data = make_token_dataset(0, 512, args.seq, cfg.vocab)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = tree_util.size(params)
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M mode={args.mode} "
          f"device={dev}")

    if args.mode == "fed":
        fcfg = FedStepConfig(n_nodes=args.nodes, local_steps=args.local_steps,
                             lr=args.lr, alpha=args.alpha, sigma=args.sigma,
                             detect=not args.no_detect)
        step = make_step(cfg, "fed_train", fcfg=fcfg)
        key = prng.PRNGKey(1)
        for r in range(args.rounds):
            nb = make_batches(cfg, data, (args.nodes, args.local_steps,
                                          args.batch), args.seq, rng, dev)
            eb = make_batches(cfg, data, (2,), args.seq, rng, dev)
            key, k = prng.split(key)
            t0 = time.perf_counter()
            params, m = step(params, nb, eb, k)
            _sync(dev)
            print(f"round {r:3d} loss={float(m['loss']):.4f} "
                  f"acc={float(m['node_accuracies'].mean()):.3f} "
                  f"normal={int(m['n_normal'])}/{args.nodes} "
                  f"dt={time.perf_counter()-t0:.2f}s", flush=True)
    else:
        step = make_step(cfg, "plain_train", lr=args.lr)
        gb = args.nodes * args.local_steps * args.batch
        for r in range(args.rounds):
            b = make_batches(cfg, data, (gb,), args.seq, rng, dev)
            t0 = time.perf_counter()
            params, loss = step(params, b)
            _sync(dev)
            print(f"step {r:3d} loss={float(loss):.4f} "
                  f"dt={time.perf_counter()-t0:.2f}s", flush=True)

    eb = make_batches(cfg, data, (8,), args.seq, rng, dev)
    with torch.no_grad():
        final_loss, metrics = loss_fn(params, cfg, eb)
    print(f"final eval: loss={float(final_loss):.4f} "
          f"acc={float(metrics['accuracy']):.3f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.rounds)
        print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
