"""Qwen2-VL-72B backbone. 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution (vision encoder STUBBED as
precomputed patch embeddings). [arXiv:2409.12191]
"""
from ..models.config import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
        rope_mode="mrope", n_patches=1024, patch_grid=(32, 32),
        qkv_bias=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=512, vocab=512,
        rope_mode="mrope", n_patches=16, patch_grid=(4, 4), qkv_bias=True,
        remat=False,
    )
