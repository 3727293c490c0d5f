"""CodeQwen1.5-7B. 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416,
qwen1.5 arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B]
"""
from ..models.config import ModelConfig

ARCH_ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=512, qkv_bias=True,
        remat=False,
    )
