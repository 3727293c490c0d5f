"""The paper's technique on a transformer LM with the PyTorch port: one
`fed_train_step` per federated round (the twin of
`examples/federated_llm.py`).

Per round: per-node local SGD → ALDP clip+noise (Eq. 8) → cloud-side
detection (Alg. 2) → masked mean + α-mix (Eq. 6).  Runs the smoke variant
of any assigned arch, checkpoints the complete training state (model, PRNG
chain, data stream) halfway through `repro_torch.checkpointing`, and
replays the second half from the checkpoint to show the resumed trajectory
is bit-exact.

  PYTHONPATH=src python examples/torch_federated_llm.py \\
      [--arch zamba2-1.2b] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import prng, tree  # noqa: E402
from repro_torch.checkpointing import (load_checkpoint,  # noqa: E402
                                       read_manifest, save_checkpoint)
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.core.fed_step import FedStepConfig  # noqa: E402
from repro_torch.data.synthetic import make_token_dataset  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.launch.steps import make_step  # noqa: E402
from repro_torch.launch.train import make_batches  # noqa: E402
from repro_torch.models import init_params  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--sigma", type=float, default=1e-3,
                    help="ALDP noise multiplier (0 turns the noise off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_smoke_config(args.arch).replace(attn_chunk=16)
    fcfg = FedStepConfig(n_nodes=args.nodes, local_steps=2, lr=0.1,
                         alpha=0.5, sigma=args.sigma, clip_s=1.0,
                         detect=True, detect_s=50.0)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    print(f"arch={cfg.name}  params={tree.size(params) / 1e6:.2f}M  "
          f"nodes={fcfg.n_nodes}  local_steps={fcfg.local_steps}  "
          f"σ={fcfg.sigma}  s={fcfg.detect_s}  device={dev}")

    seq = 32
    data = make_token_dataset(0, 256, seq, cfg.vocab)
    rng = np.random.default_rng(0)
    step = make_step(cfg, "fed_train", fcfg=fcfg)

    def train(params, key, start, stop, tag=""):
        for r in range(start, stop):
            key, k = prng.split(key)
            nb = make_batches(cfg, data, (fcfg.n_nodes, fcfg.local_steps, 2),
                              seq, rng, dev)
            eb = make_batches(cfg, data, (2,), seq, rng, dev)
            params, m = step(params, nb, eb, k)
            print(f"{tag}round {r:2d}  loss={float(m['loss']):.4f}  "
                  f"node_acc={float(m['node_accuracies'].mean()):.3f}  "
                  f"normal={int(m['n_normal'])}/{fcfg.n_nodes}  "
                  f"Δ-norm={float(m['delta_norm_mean']):.3f}", flush=True)
        return params, key

    key = prng.PRNGKey(1)
    half = max(1, args.rounds // 2)
    params, key = train(params, key, 0, half)

    # checkpoint the complete training state at the round boundary: model,
    # PRNG chain key, and the host data stream's RNG position
    with tempfile.TemporaryDirectory(prefix="fed_llm_") as tmp:
        ckpt = os.path.join(tmp, "ck")
        save_checkpoint(ckpt, {"params": params, "key": key}, step=half,
                        extra={"data_rng": rng.bit_generator.state})
        print(f"checkpointed round {half} -> {ckpt}.npz")
        params_full, _ = train(params, key, half, args.rounds)

        # kill-and-resume: reload the checkpoint, rewind the data stream,
        # and replay the second half — the final model must match bit for
        # bit
        loaded, start = load_checkpoint(ckpt, {"params": params,
                                               "key": key})
        rng.bit_generator.state = read_manifest(ckpt)["extra"]["data_rng"]
    params_resumed, _ = train(loaded["params"], loaded["key"], start,
                              args.rounds, tag="resume ")
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree.leaves(params_full), tree.leaves(params_resumed)))
    if diff != 0.0:
        raise SystemExit(f"resumed trajectory diverged: max |Δ| = {diff}")
    print(f"resume parity: rounds {half}..{args.rounds} replayed "
          f"bit-exactly (max |Δ| = {diff})")


if __name__ == "__main__":
    main()
