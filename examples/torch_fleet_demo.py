"""Fleet demo on the PyTorch port: a named scenario on the batched fleet
engines (the twin of `examples/fleet_demo.py`).

Scenarios are declarative node populations (honest, label-flip adversaries,
stragglers, churn, sampled cohorts, private+sparse uploads, async variants)
— see `repro_torch.fleet.scenarios.SCENARIOS`.  `--engine sync` runs
barrier rounds on the cohort-batched `FleetEngine`; `--engine async` runs
virtual-time arrival windows on the `AsyncFleetEngine` (Eq. 6 mixing per
arrival, streaming detection).

  PYTHONPATH=src python examples/torch_fleet_demo.py \\
      --scenario label_flip_20 --nodes 50 --rounds 8
  PYTHONPATH=src python examples/torch_fleet_demo.py --engine async \\
      --scenario async_stragglers --nodes 30 --rounds 6 --device cpu

`--mesh D` shards the node axis over D ranks: the script starts D copies of
itself, one process per rank, joined in a `torch.distributed` group (NCCL
on the card, one card per rank; gloo with `--device cpu`) through a
``file://`` store in a temporary directory.  Rank 0 prints.
"""
import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.fleet import (SCENARIOS, FleetMesh,  # noqa: E402
                               build_async_engine, build_engine,
                               get_scenario)


def run(args, mesh=None) -> None:
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    sc = get_scenario(args.scenario)
    if args.nodes:
        sc = sc.with_nodes(args.nodes)
    say(f"scenario={sc.name} nodes={sc.n_nodes} model={sc.model} "
        f"sigma={sc.sigma} sparsify={sc.sparsify_ratio} "
        f"detect={sc.detect} engine={args.engine} backend={args.backend} "
        f"device={args.device}"
        + (f" mesh={mesh.n_devices} ({mesh.backend})" if mesh else ""))
    if args.engine == "async":
        eng = build_async_engine(sc, seed=0, backend=args.backend, mesh=mesh,
                                 device=args.device)
        for rec in eng.run_arrivals(args.rounds * sc.n_nodes):
            say(f"  window={rec.window:3d} t={rec.t:8.2f}s "
                f"acc={rec.accuracy:.3f} arrivals={rec.n_processed:4d} "
                f"rejected={rec.n_rejected:3d} "
                f"tau_max={rec.max_staleness:3d} "
                f"bytes={rec.comm_bytes / 1e6:.2f}MB")
    else:
        eng = build_engine(sc, seed=0, backend=args.backend, mesh=mesh,
                           device=args.device)
        for rec in eng.run(args.rounds):
            say(f"  round={rec.round:3d} t={rec.t:8.2f}s "
                f"acc={rec.accuracy:.3f} "
                f"participants={rec.n_participating:4d} "
                f"rejected={rec.n_rejected:3d} "
                f"bytes={rec.comm_bytes / 1e6:.2f}MB")
    say(f"final accuracy: {eng.history[-1].accuracy:.3f}")
    say(f"communication efficiency κ = {eng.kappa():.4f}")


def rank_main(args) -> None:
    """One rank of a ``--mesh`` run: join the group, build the mesh, run."""
    import torch.distributed as dist

    backend = "gloo" if args.device == "cpu" else "nccl"
    dist.init_process_group(backend, init_method="file://" + args.store,
                            world_size=args.mesh, rank=args.rank)
    try:
        run(args, FleetMesh.create(args.mesh))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="honest", choices=sorted(SCENARIOS))
    ap.add_argument("--engine", default="sync", choices=["sync", "async"])
    ap.add_argument("--nodes", type=int, default=0,
                    help="override the scenario's population size")
    ap.add_argument("--rounds", type=int, default=8,
                    help="sync rounds; async processes rounds*nodes arrivals")
    ap.add_argument("--backend", default="reference",
                    choices=["reference", "pallas"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="shard the node axis over D ranks "
                         "(0 = single-device engines)")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.nodes < 0 or args.rounds < 1 or args.mesh < 0:
        ap.error("--nodes and --mesh must be >= 0 and --rounds >= 1")
    if args.rank >= 0:
        rank_main(args)
    elif args.mesh:
        # one process per rank, each this script with its rank
        argv = list(sys.argv[1:] if argv is None else argv)
        with tempfile.TemporaryDirectory(prefix="fleet_mesh_") as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)] + argv
                + ["--rank", str(r), "--store", store])
                for r in range(args.mesh)]
            codes = [p.wait() for p in procs]
        if any(codes):
            raise SystemExit(f"mesh ranks exited with {codes}")
    else:
        run(args)


if __name__ == "__main__":
    main()
