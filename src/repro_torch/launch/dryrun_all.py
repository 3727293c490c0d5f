"""Run the whole dry-run sweep: every (arch × shape × mesh), each
combination in its own process (`launch.dryrun`).

Port of `repro.launch.dryrun_all`.  ``--meshes`` picks the meshes: "1"
(one device, the default), "16x16" and "2x16x16" (one rank of the
sharded step under a fake process group).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
      [--out results/torch_dryrun] [--archs a,b] [--shapes s,t] \\
      [--meshes 1,16x16,2x16x16] [--smoke] [--timeout S]

Resumable: combinations with a JSON record already in ``--out`` are
read back, not run again.  A combination that fails or times out leaves
an ``error`` record (delete it to run it again).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCHS = ("smollm-360m", "olmo-1b", "qwen1.5-0.5b", "codeqwen1.5-7b",
         "falcon-mamba-7b", "zamba2-1.2b", "whisper-large-v3",
         "qwen2-vl-72b", "llama4-scout-17b-a16e", "kimi-k2-1t-a32b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_one(arch: str, shape: str, out_dir: str, step: str = "auto",
            smoke: bool = False, timeout: int = 7200,
            mesh: str = "1") -> dict:
    tag = (f"{arch}.{shape}.{mesh}" + ("" if step == "auto" else f".{step}")
           + (".smoke" if smoke else ""))
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--step", step, "--mesh", mesh, "--out", path]
    if smoke:
        cmd.append("--smoke")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        r = None
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    else:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
               "error": (r.stdout[-2000:] + r.stderr[-2000:]) if r else
               f"timeout after {timeout}s"}
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    rec["_wall_s"] = round(time.time() - t0, 1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--meshes", default="1")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--timeout", type=int, default=7200)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    total = ok = 0
    for mesh in args.meshes.split(","):
        for arch in args.archs.split(","):
            for shape in args.shapes.split(","):
                rec = run_one(arch, shape, args.out, smoke=args.smoke,
                              timeout=args.timeout, mesh=mesh)
                total += 1
                status = rec.get("status")
                ok += status in ("ok", "skipped")
                dom = rec.get("roofline", {}).get("dominant", "-")
                print(f"[{ok}/{total}] {arch:24s} {shape:12s} {mesh:8s} "
                      f"{status:8s} dom={dom} "
                      f"wall={rec.get('_wall_s', '-')}s", flush=True)
    print(f"done: {ok}/{total} ok")


if __name__ == "__main__":
    main()
