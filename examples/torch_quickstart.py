"""Quickstart on the PyTorch port: the paper's ALDPFL framework end to end.

The twin of `examples/quickstart.py` on `repro_torch`: the experiment is
declared once — population (10 edge nodes, 3 label-flipping adversaries),
schedule (asynchronous Eq. 6 α-mixing), privacy (node-level LDP, Eq. 8),
defense (cloud-side top-s% detection, Alg. 2 with s=80) — then compiled
and run on the card:

    spec -> compile_plan(spec) -> run(plan) -> RunReport

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs.paper_cnn import config as paper_config  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--samples", type=int, default=200,
                    help="training samples per node")
    ap.add_argument("--local-steps", type=int, default=15)
    args = ap.parse_args(argv)
    pc = paper_config()
    # sigma=0.05 keeps a workable signal-to-noise ratio at this scale; the
    # paper's own ε=8 calibration (σ≈0.47) collapses accuracy to chance
    spec = api.ExperimentSpec(
        fleet=api.FleetSpec(
            n_nodes=pc.n_nodes,
            attack=api.AttackMix(malicious_frac=pc.n_malicious / pc.n_nodes,
                                 flip_src=pc.flip_src, flip_dst=pc.flip_dst),
            model="cnn", hw=(14, 14), samples_per_node=args.samples,
            n_test=500, n_cloud_test=300),
        schedule=api.SchedulePolicy(kind="async", alpha=pc.alpha),
        privacy=api.PrivacySpec(sigma=0.05, epsilon=pc.epsilon,
                                delta=pc.delta),
        defense=api.DefenseSpec(detect=True, detect_s=pc.detect_s),
        train=api.TrainSpec(local_steps=args.local_steps, batch_size=32,
                            lr=0.1),
        rounds=args.rounds, seed=0)

    plan = api.compile_plan(spec)
    print(f"nodes={pc.n_nodes} (malicious_frac="
          f"{spec.fleet.attack.malicious_frac}), "
          f"attack: label {pc.flip_src} -> {pc.flip_dst}")
    print(f"plan: {plan.describe()}")
    print(f"LDP noise multiplier σ = {plan.sigma:.4f}")

    report = api.run(plan, device=args.device)
    for rec in report.records:
        print(f"  t={rec.t:7.2f}s  acc={rec.accuracy:.3f} "
              f"rejected={rec.n_rejected}")
    print(f"final accuracy: {report.final_accuracy:.3f}")
    print(f"privacy spent:  ε = {report.epsilon_spent:.2f} "
          f"(δ = {spec.privacy.delta})")
    print(f"communication efficiency κ = {report.kappa:.4f}")

    # the whole result round-trips through JSON (schema-versioned), so it
    # can be archived next to the spec that produced it
    payload = report.to_json()
    if api.RunReport.from_json(payload).records != report.records:
        raise SystemExit("report JSON did not round-trip")
    print(f"report JSON: {len(payload)} bytes, "
          f"schema v{report.schema_version}")


if __name__ == "__main__":
    main()
