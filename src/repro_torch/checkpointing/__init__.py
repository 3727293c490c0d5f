"""Flat .npz checkpoints with a JSON tree manifest (port of
`repro.checkpointing`; the same files)."""
from .checkpoint import (  # noqa: F401
    CheckpointError,
    load_checkpoint,
    read_manifest,
    save_checkpoint,
)
