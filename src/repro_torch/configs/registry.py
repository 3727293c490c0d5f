"""Architecture registry: ``--arch <id>`` resolution (a copy of
`repro.configs.registry`)."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (codeqwen1p5_7b, falcon_mamba_7b, kimi_k2_1t_a32b,
               llama4_scout_17b_a16e, olmo_1b, qwen1p5_0p5b, qwen2_vl_72b,
               smollm_360m, whisper_large_v3, zamba2_1p2b)

_MODULES = {
    m.ARCH_ID: m for m in (
        kimi_k2_1t_a32b, qwen2_vl_72b, zamba2_1p2b, qwen1p5_0p5b,
        whisper_large_v3, codeqwen1p5_7b, llama4_scout_17b_a16e,
        falcon_mamba_7b, olmo_1b, smollm_360m)
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """The sub-quadratic variant used for the long_500k shape.

    SSM/hybrid archs are already O(1)-state in decode; attention archs get a
    sliding window (ring-buffer KV cache of ``window`` tokens). Hybrid archs
    additionally window their shared attention block.
    """
    if cfg.family == "ssm":
        return cfg
    return cfg.replace(sliding_window=window)
