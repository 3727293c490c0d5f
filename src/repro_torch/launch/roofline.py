"""Roofline terms of a step on one NVIDIA H100.

Port of `repro.launch.roofline` with an H100 SXM table in place of the
TPU's (NVIDIA's data sheet; dense rates, at the card's 700 W limit):

  peak_bf16 = 989 TFLOP/s on the tensor cores
  peak_f32  =  67 TFLOP/s outside the tensor cores (TF32 is off: the
               port runs float32 matmuls in full float32)
  hbm_bw    = 3.35 TB/s
  nvlink_bw = 450 GB/s each way (NVLink 4: 900 GB/s per card, both ways)

  compute    = flops / peak
  memory     = bytes / hbm_bw
  collective = collective bytes / nvlink_bw

The flops, bytes and collective bytes come from `launch.cost` (counted
under fake tensors) or any other count of the same step; the model's own
flops (`model_flops`, `attention_flops`) and the fused-traffic memory
floor (`analytic_memory_bytes`) are the reference's formulas.  The
reference's HLO collective parser has no counterpart: `launch.cost`
counts the c10d operations themselves.
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

# the peak a step's matmuls run against, by the config's compute dtype
PEAKS = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": PEAK_F32}


def roofline_terms(flops: float, n_bytes: float, coll_bytes: float,
                   peak: float = PEAK_BF16) -> Dict[str, float]:
    """Seconds per step for each roofline term on one card."""
    t_compute = flops / peak
    t_memory = n_bytes / HBM_BW
    t_coll = coll_bytes / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(t_compute, t_memory, t_coll)
    terms["bound_fraction"] = (t_compute / total) if total > 0 else 0.0
    return terms


def mfu(flops: float, seconds: float, peak: float = PEAK_BF16) -> float:
    """Model-flops utilisation: the flops' share of ``peak`` over
    ``seconds`` of a measured run."""
    return flops / seconds / peak


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6·N_active·D for training, 2·N_active·D forward-only."""
    n_active = cfg.active_params()
    mult = 6.0 if shape_kind in ("train", "fed_train", "plain_train") else 2.0
    return mult * n_active * tokens


def attention_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Quadratic attention matmul flops (qkᵀ + pv), forward; ×3 for
    training.  Sliding windows cap the effective context."""
    if cfg.family == "ssm":
        return 0.0
    hd = cfg.derived_head_dim()
    d_att = cfg.n_heads * hd
    ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = (cfg.n_layers // cfg.attn_every) if cfg.attn_every \
            else 0
    # causal-optimal: half the full S×ctx rectangle
    f = 2.0 * 2.0 * batch * seq * ctx * d_att * n_attn_layers * 0.5
    if shape_kind in ("train", "fed_train", "plain_train"):
        f *= 3.0
    return f


def analytic_memory_bytes(kind: str, *, params_bytes: float,
                          cache_bytes: float, act_ckpt_bytes: float,
                          logits_bytes: float, n_dev: int,
                          moe_expert_frac: float = 1.0) -> float:
    """Per-device device-memory traffic LOWER BOUND (perfect fusion):
    parameter reads (+ grad writes for training), the KV/state cache read
    and written, activation checkpoints and logits."""
    pb = params_bytes * moe_expert_frac
    if kind in ("fed_train", "plain_train", "train"):
        total = 3.0 * params_bytes + 2.0 * act_ckpt_bytes + logits_bytes
    elif kind == "prefill":
        total = pb + cache_bytes + act_ckpt_bytes + logits_bytes
    else:  # decode
        total = pb + 2.0 * cache_bytes + logits_bytes
    return total / n_dev
