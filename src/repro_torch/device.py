"""Device resolution and the port's numerics policy on the card."""
from __future__ import annotations

import torch


def set_precision() -> None:
    """Full float32 everywhere, and runs that repeat bit for bit.

    cuDNN convolutions default to TF32, which keeps about three decimal
    digits and would break parity with the reference.  cuDNN is held to
    its deterministic algorithms, and to a fixed choice among them (no
    benchmarking), because one delta moved by its last bit can carry an
    element across the DGC threshold and change a run's records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise.  Raises when CUDA is asked for (explicitly or by default)
    and no card is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    set_precision()
    return dev
