"""Zamba2-1.2B. 38 Mamba2 blocks d_model=2048 with a SHARED full-attention
block (32H, kv=32, d_ff=8192) applied every 6 layers; ssm_state=64.
[arXiv:2411.15242]
"""
from ..models.config import ModelConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000,
        ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, chunk=128),
        attn_every=6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        ssm=SSMConfig(kind="mamba2", d_state=16, head_dim=32, chunk=8),
        attn_every=2, remat=False,
    )
