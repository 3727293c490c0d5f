"""Parameter trees between the reference and the port.

The reference keeps params as nested dicts of JAX arrays; the port keeps
nested dicts of torch tensors with the same keys, shapes and layouts
(the CNN stays NHWC/HWIO at its public functions, the model zoo keeps its
stacked layer axis).  Both directions go through numpy, so a test hands
the same weights to both packages.

bfloat16 crosses bit for bit: numpy has no bfloat16 of its own (JAX's
arrays come out as `ml_dtypes.bfloat16`, which `torch.as_tensor`
rejects), so the bits travel as a 16-bit integer view."""
from __future__ import annotations

import numpy as np
import torch

from . import tree as tree_util


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # numpy's bfloat16 (installed with JAX)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device="cpu"):
    """Nested dict of array-likes (numpy, JAX arrays) -> dict of tensors."""
    return tree_util.map(lambda x: _leaf_to_torch(x, device), tree)


def to_numpy(tree):
    """Nested dict of tensors -> dict of numpy arrays (same keys/shapes;
    bfloat16 leaves as `ml_dtypes.bfloat16`)."""
    return tree_util.map(_leaf_to_numpy, tree)
