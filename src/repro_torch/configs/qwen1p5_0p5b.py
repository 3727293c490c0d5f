"""Qwen1.5-0.5B. 24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B]
"""
from ..models.config import ModelConfig

ARCH_ID = "qwen1.5-0.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151936, qkv_bias=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=512, qkv_bias=True,
        remat=False,
    )
