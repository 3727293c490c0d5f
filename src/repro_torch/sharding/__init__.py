"""Sharding of the LLM steps over a `torch.distributed` device mesh.

Port of `repro.sharding`: the partition rules (`rules`) and the in-model
mesh context (`ctx`)."""
from .rules import (batch_pspec, cache_pspecs, fed_batch_pspec,  # noqa: F401
                    param_pspecs, shardings_for)
