"""Llama-4-Scout-17B-16E backbone. 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192, vocab=202048, MoE 16 experts top-1 (+shared), early fusion
(multimodal embeddings stubbed). [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from ..models.config import ModelConfig, MoEConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_expert=8192, n_shared=1),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        # capacity_factor 8: at smoke scale (T=32, E=4) a factor-2 capacity
        # sits at the dropping edge, and capacity drops are batch-context
        # dependent — they break prefill/decode vs full-forward equivalence
        moe=MoEConfig(n_experts=4, top_k=1, d_expert=256, n_shared=1,
                      capacity_factor=8.0),
        remat=False,
    )
