"""The paper's edge models (CNN, MLP) and the model zoo's decoder (the
dense, moe, ssm, hybrid, vlm and audio families, `models.moe` the MoE
FFN), on nested dicts of tensors."""
from .config import ModelConfig, MoEConfig, SSMConfig          # noqa: F401
from .model import (decode_step, forward, init_cache, init_params,  # noqa: F401
                    loss_fn, prefill)
