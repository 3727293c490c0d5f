"""Parameter trees between the reference and the port.

The reference keeps params as nested dicts of JAX arrays; the port keeps
nested dicts of torch tensors with the same keys, shapes and layouts
(the CNN stays NHWC/HWIO at its public functions).  Both directions go
through numpy, so a test hands the same weights to both packages."""
from __future__ import annotations

import numpy as np
import torch

from . import tree as tree_util


def to_torch(tree, device="cpu"):
    """Nested dict of array-likes (numpy, JAX arrays) -> dict of tensors."""
    return tree_util.map(
        lambda x: torch.as_tensor(np.array(x), device=device), tree)


def to_numpy(tree):
    """Nested dict of tensors -> dict of numpy arrays (same keys/shapes)."""
    return tree_util.map(lambda x: x.detach().cpu().numpy(), tree)
