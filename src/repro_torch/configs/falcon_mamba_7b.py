"""Falcon-Mamba-7B. 64L d_model=4096 attention-free Mamba1, ssm_state=16,
vocab=65024. [arXiv:2410.05355]
"""
from ..models.config import ModelConfig, SSMConfig

ARCH_ID = "falcon-mamba-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm", n_layers=64, d_model=4096,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024, rope_mode="none",
        # chunk=512 from the §Perf sweep: per-chunk loop overheads amortise
        # (memory term 131s -> 88s vs chunk=128); <6% beyond 512. bf16 scan
        # elements halve scan traffic at 0.13% relative logit error.
        ssm=SSMConfig(kind="mamba1", d_state=16, chunk=512,
                      scan_dtype="bfloat16"),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm", n_layers=2, d_model=256,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=512, rope_mode="none",
        ssm=SSMConfig(kind="mamba1", d_state=8, chunk=8), remat=False,
    )
