"""Dry run of one (arch × input shape) step on one device: its cost and
roofline without running it.

Port of `repro.launch.dryrun` for one NVIDIA H100.  The reference lowers
and compiles every step against a 256- or 512-chip TPU mesh and reads the
compiled program's memory and cost analyses; the port runs the step once
under fake tensors (`launch.cost`: no storage, no device) and writes the
reference's record fields:

  status, memory (argument, output and peak temporary bytes, and
  per_device_total_gib against the card's 80 GB), cost (flops and bytes
  counted from the step's operations), collectives (none on one device),
  roofline (the three terms on an H100, model_flops_global,
  attention_flops_global, useful_flops_ratio, memory_lb_s, dominant_lb).

Attention is counted as its plain version's operations: a fake tensor is
a CPU tensor, on which the flash-attention wrapper runs its plain
version.  The multi-device meshes of the reference (16x16, 2x16x16)
belong to the LLM half of ROADMAP.md item 15.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--step fed|plain|auto] [--smoke] --out out.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import numpy as np

from .. import tree as tree_util
from ..configs import get_config, get_smoke_config, long_context_variant
from ..core import aldp
from ..core.fed_step import FedStepConfig
from . import roofline as rl
from .cost import step_cost
from .shapes import LONG_SKIP, SHAPES, input_specs
from .steps import make_step

DEVICE_MEMORY_GB = 80           # one H100 SXM
FED_NODES = 16                  # the reference's data axis of its 16x16 mesh


def resolve_config(arch: str, shape_name: str, ssm_chunk: int = 0,
                   smoke: bool = False):
    """The config a (arch, shape) dry run traces (None: skipped)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if shape_name == "long_500k":
        if arch in LONG_SKIP:
            return None
        cfg = long_context_variant(cfg)
    if ssm_chunk and cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    return cfg


def build_fcfg(local_steps: int = 4, n_nodes: int = FED_NODES
               ) -> FedStepConfig:
    return FedStepConfig(n_nodes=n_nodes, local_steps=local_steps,
                         lr=1e-2, alpha=0.5, clip_s=1.0, sigma=1e-3,
                         detect=True, detect_s=80.0)


@contextlib.contextmanager
def whole_leaf_noise(params):
    """The noise chain draws `aldp.NOISE_CHUNK` counters at a time, which
    bounds the card's memory; fake tensors hold none, so the trace draws
    each leaf in one chunk: the same operations on the same elements in
    fewer, larger calls (the flops and bytes counted are the same)."""
    chunk = aldp.NOISE_CHUNK
    aldp.NOISE_CHUNK = max(chunk, max(x.numel() for x in
                                      tree_util.leaves(params)))
    try:
        yield
    finally:
        aldp.NOISE_CHUNK = chunk


def _tree_bytes(t) -> float:
    def leaves(x):
        if isinstance(x, (tuple, list)):
            return [y for e in x for y in leaves(e)]
        return tree_util.leaves(x)
    return float(sum(x.numel() * x.element_size() for x in leaves(t)
                     if hasattr(x, "element_size")))


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               step: str = "auto", local_steps: int = 4,
               n_nodes: int = FED_NODES, ssm_chunk: int = 0,
               smoke: bool = False) -> dict:
    """The dry-run record of one (arch, shape); ``smoke`` traces the
    arch's smoke config, ``n_nodes`` × ``local_steps`` is the fed_train
    layout of ``train_4k`` (the reference's 16 × 4 by default)."""
    if multi_pod:
        raise NotImplementedError(
            "a multi-pod dry run needs a device mesh: the LLM half of "
            "ROADMAP.md item 15 ('Multi-device: torch.distributed')")
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "devices": 1,
           "device": "NVIDIA H100 SXM (80 GB)", "smoke": smoke,
           "status": "ok"}
    cfg = resolve_config(arch, shape_name, ssm_chunk, smoke)
    if cfg is None:
        rec.update(status="skipped",
                   reason="encoder-decoder: 500k autoregressive transcript "
                          "decode has no serving analogue")
        return rec
    shape = SHAPES[shape_name]
    fcfg = build_fcfg(local_steps, n_nodes) if shape.kind == "train" \
        else None
    spec = input_specs(cfg, shape_name, step=step, fcfg=fcfg)
    kind, args = spec["kind"], spec["args"]
    rec["step_kind"] = kind
    if kind == "fed_train":
        # the port's PRNG keys live on the host
        args = args[:3] + (np.zeros(2, np.uint32),)
        rec["fed_layout"] = {"nodes": fcfg.n_nodes,
                             "local_steps": fcfg.local_steps,
                             "per_node_batch": int(args[1]["tokens"]
                                                   .shape[2])}
    step_fn = make_step(cfg, kind, fcfg=fcfg)

    t0 = time.time()
    with whole_leaf_noise(args[0]):
        cost = step_cost(step_fn, *args)
    rec["timings"] = {"trace_s": round(time.time() - t0, 2)}

    # ---- memory: inputs, and the peak of the live results ----
    arg_bytes = _tree_bytes(args)
    rec["memory"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "temp_size_in_bytes": int(cost.peak_live_bytes),
        "per_device_total_gib": round((arg_bytes + cost.peak_live_bytes)
                                      / 2**30, 3),
        "device_gb": DEVICE_MEMORY_GB,
        "fits": bool(arg_bytes + cost.peak_live_bytes
                     <= DEVICE_MEMORY_GB * 1e9)}

    # ---- the operations' own counts ----
    rec["cost"] = {"flops": cost.flops, "bytes": cost.bytes,
                   "n_ops": cost.n_ops,
                   "flops_by_op": dict(sorted(cost.flops_by_op.items())),
                   "attention": "counted as its plain version's operations",
                   "source": "launch.cost under FakeTensorMode"}
    rec["collectives"] = {"bytes_by_type": cost.coll_bytes,
                          "count_by_type": cost.coll_counts,
                          "total_bytes_per_device":
                              int(cost.total_coll_bytes)}

    # ---- roofline on one H100 ----
    peak = rl.PEAKS[cfg.compute_dtype]
    terms = rl.roofline_terms(cost.flops, cost.bytes, cost.total_coll_bytes,
                              peak=peak)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mf = rl.model_flops(cfg, kind, tokens)
    rec["roofline"] = terms
    rec["roofline"]["peak_flops"] = peak
    rec["roofline"]["model_flops_global"] = mf
    rec["roofline"]["attention_flops_global"] = rl.attention_flops(
        cfg, kind, shape.global_batch, shape.seq_len)
    rec["roofline"]["counted_flops_global"] = cost.flops
    rec["roofline"]["useful_flops_ratio"] = (
        round(mf / cost.flops, 4) if cost.flops else None)

    # the fused-traffic floor (perfect fusion), against the counted
    # upper bound above (every operation's operands and results)
    pb = _tree_bytes(args[0])
    cb = _tree_bytes(args[2]) if kind in ("prefill", "decode") else 0.0
    s_eff = shape.seq_len if kind != "decode" else 1
    act = cfg.n_layers * shape.global_batch * s_eff * cfg.d_model * 2.0
    logits_b = shape.global_batch * s_eff * cfg.vocab * 4.0
    frac = 1.0
    if cfg.family == "moe" and kind == "decode":
        frac = min(1.0, shape.global_batch * cfg.moe.top_k
                   / cfg.moe.n_experts)
    mem_lb = rl.analytic_memory_bytes(
        kind, params_bytes=pb, cache_bytes=cb, act_ckpt_bytes=act,
        logits_bytes=logits_b, n_dev=1, moe_expert_frac=frac)
    rec["roofline"]["memory_lb_s"] = mem_lb / rl.HBM_BW
    rec["roofline"]["params_bytes_global"] = pb
    rec["roofline"]["cache_bytes_global"] = cb
    dom_lb = {"compute_s": terms["compute_s"],
              "memory_s": rec["roofline"]["memory_lb_s"],
              "collective_s": terms["collective_s"]}
    rec["roofline"]["dominant_lb"] = max(dom_lb, key=dom_lb.get)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--step", default="auto", choices=("auto", "fed", "plain"))
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config instead of its full one")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    try:
        rec = run_dryrun(args.arch, args.shape, multi_pod=args.multi_pod,
                         step=args.step, local_steps=args.local_steps,
                         ssm_chunk=args.ssm_chunk, smoke=args.smoke)
    except NotImplementedError:
        raise
    except Exception as e:      # the record carries the failure
        rec = {"arch": args.arch, "shape": args.shape, "mesh": "1",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
    out = json.dumps(rec, indent=2, default=str)
    if args.out:            # first: a closed stdout must not lose the record
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    if rec.get("status") == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
