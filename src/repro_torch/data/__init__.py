"""Synthetic federated data (numpy copies of `repro.data`)."""
from .federated import make_federated_image_data  # noqa: F401
from .synthetic import (make_image_dataset,  # noqa: F401
                        make_token_dataset, partition_dirichlet,
                        partition_iid)
