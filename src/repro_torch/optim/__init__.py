"""The reference's optimizers (SGD, Momentum, AdamW) on tensor trees."""
from .optimizers import SGD, AdamW, Momentum, make_optimizer   # noqa: F401
