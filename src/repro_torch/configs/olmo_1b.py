"""OLMo-1B. 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304 —
non-parametric LayerNorm. [arXiv:2402.00838]
"""
from ..models.config import ModelConfig

ARCH_ID = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
        norm="nonparam_ln",
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=512, norm="nonparam_ln",
        remat=False,
    )
