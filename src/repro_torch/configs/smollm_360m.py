"""SmolLM-360M. 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 —
llama-arch small. [hf:HuggingFaceTB/SmolLM-360M]
"""
from ..models.config import ModelConfig

ARCH_ID = "smollm-360m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=32, d_model=960,
        n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49152,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=240,
        n_heads=3, n_kv_heads=1, d_ff=512, vocab=512, remat=False,
    )
