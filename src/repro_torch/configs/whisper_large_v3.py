"""Whisper-large-v3 backbone. 32L enc + 32L dec, d_model=1280 20H d_ff=5120
vocab=51866 — encoder-decoder; mel+conv frontend STUBBED as 1500 precomputed
frame embeddings. LayerNorm + GELU per the original. [arXiv:2212.04356]
"""
from ..models.config import ModelConfig

ARCH_ID = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio", n_layers=32, encoder_layers=32,
        d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
        norm="layernorm", mlp="gelu", n_audio_frames=1500, qkv_bias=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio", n_layers=2, encoder_layers=2,
        d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        norm="layernorm", mlp="gelu", n_audio_frames=24, qkv_bias=True,
        remat=False,
    )
