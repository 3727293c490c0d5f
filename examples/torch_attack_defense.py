"""Attack vs defence on the PyTorch port: both attacks from the paper, and
both defences (the twin of `examples/attack_defense.py`).

1. Label-flipping (poisoning): 30% malicious nodes flip class 1 -> 7; compare
   ALDPFL accuracy with and without the cloud-side detection mechanism.
2. Gradient leakage (DLG): a malicious cloud reconstructs a node's input from
   its gradients; the ALDP noise breaks the reconstruction.

  PYTHONPATH=src python examples/torch_attack_defense.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import api, prng  # noqa: E402
from repro_torch.core.aldp import add_gaussian_noise  # noqa: E402
from repro_torch.core.attacks import (dlg_attack,  # noqa: E402
                                      reconstruction_mse)
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models.cnn import cnn_forward  # noqa: E402


def per_class_accuracy(params, x, y, cls: int) -> float:
    """Accuracy restricted to one class (the paper's 'special task')."""
    with torch.no_grad():
        pred = cnn_forward(params, x).argmax(-1)
    sel = y == cls
    return float(torch.where(sel, pred == y, False).sum()
                 / torch.clamp(sel.sum(), min=1))


def label_flip_experiment(dev, rounds: int, samples: int,
                          local_steps: int) -> None:
    print("=== 1. label-flipping attack (p=30%) ===")
    for detect in (False, True):
        spec = api.ExperimentSpec(
            fleet=api.FleetSpec(n_nodes=10,
                                attack=api.AttackMix(malicious_frac=0.3),
                                model="cnn", hw=(14, 14),
                                samples_per_node=samples, n_test=400,
                                n_cloud_test=300),
            schedule=api.SchedulePolicy(kind="async"),
            privacy=api.PrivacySpec(sigma=0.05),
            defense=api.DefenseSpec(detect=detect),
            train=api.TrainSpec(local_steps=local_steps, batch_size=32,
                                lr=0.1),
            rounds=rounds, seed=0)
        plan = api.compile_plan(spec)
        pop = api.materialize(spec, device=dev)
        rep = api.run(plan, population=pop, device=dev)
        x, y = (torch.as_tensor(a, device=dev) for a in pop.test_data)
        special = per_class_accuracy(rep.final_params, x, y, 1)
        print(f"  detection={'ON ' if detect else 'OFF'}  "
              f"general acc={rep.final_accuracy:.3f}  "
              f"class-1 acc={special:.3f}  "
              f"rejected={sum(r.n_rejected for r in rep.records)} updates")


def dlg_experiment(dev, steps: int) -> None:
    print("=== 2. gradient-leakage (DLG) attack vs ALDP ===")
    W = prng.normal(prng.PRNGKey(0), (64, 10), dev) * 0.2

    def loss(params, x, y_soft):
        return torch.mean((x @ params - y_soft) ** 2)

    # two samples: the rank-2 gradient pins the reconstruction scale
    x_true = prng.normal(prng.PRNGKey(1), (2, 64), dev) * 0.5
    y_true = torch.nn.functional.one_hot(torch.tensor([3, 7], device=dev),
                                         10).to(torch.float32)
    w = W.detach().requires_grad_(True)
    g = torch.autograd.grad(loss(w, x_true, y_true), w)[0]
    for sigma in (0.0, 0.1, 0.5):
        g_obs = g if sigma == 0 else add_gaussian_noise(
            g, prng.PRNGKey(2), sigma, 1.0)
        x_rec, _ = dlg_attack(loss, W, g_obs, (2, 64), 10, prng.PRNGKey(3),
                              steps=steps, lr=0.1)
        mse = float(reconstruction_mse(x_true, x_rec))
        verdict = "LEAKED" if mse < 0.05 else "protected"
        print(f"  σ={sigma:4.2f}: reconstruction MSE={mse:8.4f}  -> {verdict}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--local-steps", type=int, default=12)
    ap.add_argument("--dlg-steps", type=int, default=400)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    label_flip_experiment(dev, args.rounds, args.samples, args.local_steps)
    dlg_experiment(dev, args.dlg_steps)


if __name__ == "__main__":
    main()
