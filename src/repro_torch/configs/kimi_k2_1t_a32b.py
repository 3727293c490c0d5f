"""Kimi K2 — trillion-param MoE. 61L d_model=7168 64H (GQA kv=8) expert
d_ff=2048, vocab=163840, MoE 384 experts top-8 (+1 shared). [arXiv:2501.kimi2]
"""
from ..models.config import ModelConfig, MoEConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, n_shared=1,
                      capacity_factor=2.0),
        remat=False,
    )
