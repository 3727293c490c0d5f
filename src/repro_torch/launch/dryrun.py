"""Dry run of one (arch × input shape) step, on one device or on a device
mesh: its cost and roofline without running it.

Port of `repro.launch.dryrun` for NVIDIA H100s.  The reference lowers
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
version.

``--mesh 16x16`` and ``--mesh 2x16x16`` (or ``--multi-pod``, the
reference's flag, an alias of it) trace the sharded step of one rank of
the reference's meshes, (data 16, model 16) and (pod 2,
data 16, model 16) of H100s, in this one process: a "fake" process group
of 256 or 512 ranks (`launch.mesh.fake_world`), the args placed by
`launch.steps.arg_pspecs` as DTensors over fake local shards, and the
step run under `sharding.ctx.mesh_context`.  The fed step's nodes are
the dp axes' size (the reference's `build_fcfg`).  The record's memory,
cost and collectives are rank 0's (per device), and its roofline adds
the collective term over NVLink.  The one-device dry run is the default.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--mesh 1|16x16|2x16x16] [--multi-pod] \\
      [--step fed|plain|auto] [--seq-parallel] [--smoke] --out out.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import numpy as np
import torch

from .. import tree as tree_util
from ..configs import get_config, get_smoke_config, long_context_variant
from ..core import aldp
from ..core.fed_step import FedStepConfig
from ..models import ssm
from . import roofline as rl
from .cost import step_cost
from .shapes import LONG_SKIP, SHAPES, input_specs
from .steps import make_step

DEVICE_MEMORY_GB = 80           # one H100 SXM
FED_NODES = 16                  # the reference's data axis of its 16x16 mesh


def resolve_config(arch: str, shape_name: str, ssm_chunk: int = 0,
                   smoke: bool = False, seq_parallel: bool = False):
    """The config a (arch, shape) dry run traces (None: skipped)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if shape_name == "long_500k":
        if arch in LONG_SKIP:
            return None
        cfg = long_context_variant(cfg)
    if ssm_chunk and cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    if seq_parallel:
        cfg = cfg.replace(seq_parallel=True)
    return cfg


MESHES = ("1", "16x16", "2x16x16")
# the route a mesh record of a Mamba family prices (`models.model._mixer`)
MIXER_TP = ("tensor parallel on 'model': each model rank runs its block of "
            "d_inner (Mamba2: of the heads) for its batch block; x_proj's "
            "(Mamba1) or the gated norm's (Mamba2) partial sums and "
            "out_proj's are all-reduced (models.ssm.mixer_tp)")
MIXER_REPLICATED = ("replicated on 'model', which does not divide d_inner "
                    "(Mamba2: the heads): each model rank gathers the "
                    "mixer's weights and runs the whole mixer for its batch "
                    "block, so the mixers' work is repeated model-axis "
                    "times")


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


def run_dryrun(arch: str, shape_name: str, *, mesh: str = "1",
               step: str = "auto", local_steps: int = 4,
               n_nodes: int = FED_NODES, ssm_chunk: int = 0,
               smoke: bool = False, seq_parallel: bool = False) -> dict:
    """The dry-run record of one (arch, shape); ``smoke`` traces the
    arch's smoke config.  On one device (``mesh`` "1") ``n_nodes`` ×
    ``local_steps`` is the fed_train layout of ``train_4k`` (the
    reference's 16 × 4 by default); on ``mesh`` "16x16" or "2x16x16"
    the fed step's nodes are the dp axes' size and the record is one
    rank's (`_trace_mesh`)."""
    n_dev = {"1": 1, "16x16": 256, "2x16x16": 512}[mesh]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "devices": n_dev, "device": "NVIDIA H100 SXM (80 GB)",
           "smoke": smoke, "status": "ok"}
    cfg = resolve_config(arch, shape_name, ssm_chunk, smoke, seq_parallel)
    if cfg is None:
        rec.update(status="skipped",
                   reason="encoder-decoder: 500k autoregressive transcript "
                          "decode has no serving analogue")
        return rec
    if seq_parallel:
        rec["seq_parallel"] = True
    shape = SHAPES[shape_name]
    if n_dev > 1:
        kind, args, cost, arg_bytes, seconds = _trace_mesh(
            rec, cfg, shape, step, local_steps, mesh == "2x16x16")
    else:
        fcfg = build_fcfg(local_steps, n_nodes) if shape.kind == "train" \
            else None
        kind, args = _inputs(rec, cfg, shape, step, fcfg)
        t0 = time.time()
        with whole_leaf_noise(args[0]):
            cost = step_cost(make_step(cfg, kind, fcfg=fcfg), *args)
        seconds, arg_bytes = time.time() - t0, _tree_bytes(args)
    rec["timings"] = {"trace_s": round(seconds, 2)}

    # ---- memory: inputs, and the peak of the live results ----
    rec["memory"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "temp_size_in_bytes": int(cost.peak_live_bytes),
        "per_device_total_gib": round((arg_bytes + cost.peak_live_bytes)
                                      / 2**30, 3),
        "device_gb": DEVICE_MEMORY_GB,
        "fits": bool(arg_bytes + cost.peak_live_bytes
                     <= DEVICE_MEMORY_GB * 1e9)}

    # ---- the operations' own counts (one rank's on a mesh) ----
    rec["cost"] = {"flops": cost.flops, "bytes": cost.bytes,
                   "n_ops": cost.n_ops,
                   "flops_by_op": dict(sorted(cost.flops_by_op.items())),
                   "attention": "counted as its plain version's operations",
                   "source": "launch.cost under FakeTensorMode"
                   + (" and a fake process group" if n_dev > 1 else "")}
    if n_dev > 1:
        rec["cost"]["per"] = "device (rank 0)"
    rec["collectives"] = {"bytes_by_type": cost.coll_bytes,
                          "count_by_type": cost.coll_counts,
                          "total_bytes_per_device":
                              int(cost.total_coll_bytes)}

    # ---- roofline on the H100 table ----
    peak = rl.PEAKS[cfg.compute_dtype]
    terms = rl.roofline_terms(cost.flops, cost.bytes, cost.total_coll_bytes,
                              peak=peak)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mf = rl.model_flops(cfg, kind, tokens)
    counted = cost.flops * n_dev
    rec["roofline"] = terms
    rec["roofline"]["peak_flops"] = peak
    rec["roofline"]["model_flops_global"] = mf
    rec["roofline"]["attention_flops_global"] = rl.attention_flops(
        cfg, kind, shape.global_batch, shape.seq_len)
    rec["roofline"]["counted_flops_global"] = counted
    rec["roofline"]["useful_flops_ratio"] = (
        round(mf / counted, 4) if counted else None)

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
        logits_bytes=logits_b, n_dev=n_dev, moe_expert_frac=frac)
    rec["roofline"]["memory_lb_s"] = mem_lb / rl.HBM_BW
    rec["roofline"]["params_bytes_global"] = pb
    rec["roofline"]["cache_bytes_global"] = cb
    dom_lb = {"compute_s": terms["compute_s"],
              "memory_s": rec["roofline"]["memory_lb_s"],
              "collective_s": terms["collective_s"]}
    rec["roofline"]["dominant_lb"] = max(dom_lb, key=dom_lb.get)
    return rec


def _inputs(rec, cfg, shape, step, fcfg):
    """The step's kind and meta-tensor args (the fed step's PRNG key on
    the host, where the port keeps keys); records the step kind and the
    fed layout."""
    spec = input_specs(cfg, shape.name, step=step, fcfg=fcfg)
    kind, args = spec["kind"], spec["args"]
    rec["step_kind"] = kind
    if kind == "fed_train":
        args = args[:3] + (np.zeros(2, np.uint32),)
        rec["fed_layout"] = {"nodes": fcfg.n_nodes,
                             "local_steps": fcfg.local_steps,
                             "per_node_batch": int(args[1]["tokens"]
                                                   .shape[2])}
    return kind, args


def _trace_mesh(rec, cfg, shape, step, local_steps, multi_pod):
    """Rank 0's run of the sharded step under a fake process group of
    256 or 512 ranks: the args placed by `arg_pspecs` as DTensors over
    fake local shards (the caches' counters fake plain tensors), the step
    under `sharding.ctx.mesh_context`, counted by `cost.CostMode`.
    Returns (kind, the global meta args, cost, this rank's argument
    bytes, seconds)."""
    import logging

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from ..sharding import ctx
    from ..sharding.rules import place, shardings_for
    from .cost import CostMode
    from .mesh import fake_world, make_production_mesh
    from .steps import arg_pspecs, dp_axes_for

    # DTensor warns of every multi-axis all-reduce it splits in two
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        dp = dp_axes_for(mesh)
        if cfg.family in ("ssm", "hybrid"):
            rec["mamba_mixer"] = (
                MIXER_TP if ssm.tp_blocks(cfg, mesh.size(
                    mesh.mesh_dim_names.index("model")))
                else MIXER_REPLICATED)
        fcfg = None
        if shape.kind == "train":
            sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
            fcfg = build_fcfg(local_steps,
                              int(np.prod([sizes[a] for a in dp])))
        kind, args = _inputs(rec, cfg, shape, step, fcfg)
        pspecs = arg_pspecs(cfg, kind, mesh, args)
        fake = FakeTensorMode(allow_non_fake_inputs=False)

        def shard(x, placements):
            local, _ = ctx.local_box(tuple(x.shape), mesh, placements)
            with fake:
                loc = torch.empty(local, dtype=x.dtype)
            return DTensor.from_local(
                loc, mesh, placements, run_check=False, shape=x.shape,
                stride=torch.empty(tuple(x.shape), device="meta").stride())

        placed = _fake_plain(place(mesh, args, pspecs, make=shard), fake)
        step_fn = make_step(
            cfg, kind, fcfg=fcfg,
            spmd_axes=dp if kind == "fed_train" else None,
            param_shardings=(shardings_for(mesh, pspecs[0])
                             if kind == "plain_train" else None))
        t0 = time.time()
        counter = CostMode()
        with whole_leaf_noise(args[0]), fake, counter, \
                ctx.mesh_context(mesh, dp):
            step_fn(*placed)
        return (kind, args, counter.cost, _local_bytes(placed),
                time.time() - t0)


def _fake_plain(tree, fake):
    """The leaves ``place`` leaves plain (the caches' counters) as fake
    tensors of ``fake``."""
    from ..sharding import ctx
    if isinstance(tree, dict):
        return {k: _fake_plain(v, fake) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fake_plain(v, fake) for v in tree)
    if isinstance(tree, torch.Tensor) and not ctx.is_dtensor(tree):
        with fake:
            return torch.empty(tuple(tree.shape), dtype=tree.dtype)
    return tree


def _local_bytes(tree) -> float:
    """This rank's bytes of a tree of DTensors and plain tensors."""
    from ..sharding import ctx

    def leaves(x):
        if isinstance(x, (tuple, list)):
            return [y for e in x for y in leaves(e)]
        return tree_util.leaves(x)
    return float(sum(
        (x.to_local() if ctx.is_dtensor(x) else x).numel() * x.element_size()
        for x in leaves(tree) if hasattr(x, "element_size")))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="1", choices=MESHES,
                    help="1: one device; 16x16: the single-pod mesh; "
                         "2x16x16: two pods")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's flag: --mesh 2x16x16")
    ap.add_argument("--step", default="auto", choices=("auto", "fed", "plain"))
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="pin the residual stream's sequence on 'model'")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config instead of its full one")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.multi_pod:
        args.mesh = "2x16x16"
    try:
        rec = run_dryrun(args.arch, args.shape, mesh=args.mesh,
                         step=args.step, local_steps=args.local_steps,
                         ssm_chunk=args.ssm_chunk, smoke=args.smoke,
                         seq_parallel=args.seq_parallel)
    except Exception as e:      # the record carries the failure
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
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
