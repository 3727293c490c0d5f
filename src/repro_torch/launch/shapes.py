"""Assigned input shapes and meta-device stand-ins for every model input.

Port of `repro.launch.shapes`.  ``input_specs(cfg, shape_name, ...)``
returns the argument trees the corresponding step function takes, with
the reference's shapes and dtypes, as tensors on the ``meta`` device:
nothing is allocated, whatever the model's size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import tree as tree_util
from ..core.fed_step import FedStepConfig
from ..models import init_cache, init_params
from ..models.config import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}

# long_500k decode for pure full-attention archs uses the sliding-window
# variant (see configs.registry.long_context_variant); whisper skips it.
LONG_SKIP = ("whisper-large-v3",)


def meta(shape, dtype) -> torch.Tensor:
    """A ``meta``-device tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _lm_batch(cfg: ModelConfig, batch: int, seq: int, *, targets: bool,
              lead: Tuple[int, ...] = ()) -> dict:
    """Token batch stand-ins with the family extras (patches, frames)."""
    s_text = seq
    out: dict = {}
    if cfg.family == "vlm":
        s_text = seq - cfg.n_patches
        out["patches"] = meta(lead + (batch, cfg.n_patches, cfg.d_model),
                              _dtype(cfg.compute_dtype))
    if cfg.family == "audio":
        out["frames"] = meta(lead + (batch, cfg.n_audio_frames, cfg.d_model),
                             _dtype(cfg.compute_dtype))
    out["tokens"] = meta(lead + (batch, s_text), torch.int32)
    if targets:
        out["targets"] = meta(lead + (batch, s_text), torch.int32)
    return out


def fed_layout(shape: InputShape, n_nodes: int,
               local_steps: int) -> Tuple[int, int, int]:
    """(nodes, local_steps, per_node_batch) factorisation of global_batch."""
    per = shape.global_batch // (n_nodes * local_steps)
    if per < 1:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"cover {n_nodes} nodes x {local_steps} steps")
    return n_nodes, local_steps, per


def _as_meta(tree):
    return tree_util.map(lambda x: meta(x.shape, x.dtype), tree)


def params_struct(cfg: ModelConfig, seed: int = 0):
    """The model's params as meta tensors: `init_params` traced under
    fake tensors, so no draw is stored.  One layer of each stack is
    traced and its leaves given the stack's depth (every layer of a stack
    has the same shapes), so a deep model traces as fast as a shallow
    one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    one = cfg.replace(n_layers=1, encoder_layers=min(cfg.encoder_layers, 1))
    with FakeTensorMode():
        fake = init_params(one, torch.Generator().manual_seed(seed), "cpu")
    tree = _as_meta(fake)

    def deepen(stack, n):
        return tree_util.map(lambda x: meta((n,) + tuple(x.shape[1:]),
                                            x.dtype), stack)

    tree["blocks"] = deepen(tree["blocks"], cfg.n_layers)
    if "encoder" in tree:
        tree["encoder"]["blocks"] = deepen(tree["encoder"]["blocks"],
                                           cfg.encoder_layers)
    return tree


def cache_struct(cfg: ModelConfig, batch: int, cache_len: int):
    """The bf16 serving cache as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_cache(cfg, batch, cache_len, dtype=torch.bfloat16)
    return _as_meta(fake)


def input_specs(cfg: ModelConfig, shape_name: str, *,
                step: str = "auto", fcfg: Optional[FedStepConfig] = None
                ) -> dict:
    """{"args": tuple of meta-tensor trees, "kind": str} for the step
    function (`launch.steps.make_step`).

    step: 'fed' | 'plain' (train shapes); 'auto' picks by shape kind.
    """
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        if step in ("auto", "fed"):
            if fcfg is None:
                raise ValueError("a fed_train step needs its FedStepConfig")
            n, h, per = fed_layout(shape, fcfg.n_nodes, fcfg.local_steps)
            node_batches = _lm_batch(cfg, per, shape.seq_len, targets=True,
                                     lead=(n, h))
            eval_batch = _lm_batch(cfg, 2, min(shape.seq_len, 4096),
                                   targets=True)
            key = meta((2,), torch.uint32)
            return {"kind": "fed_train",
                    "args": (params_struct(cfg), node_batches, eval_batch,
                             key)}
        batch = _lm_batch(cfg, shape.global_batch, shape.seq_len,
                          targets=True)
        return {"kind": "plain_train", "args": (params_struct(cfg), batch)}
    cache_len = (min(shape.seq_len, cfg.sliding_window)
                 if cfg.sliding_window else shape.seq_len)
    cache = cache_struct(cfg, shape.global_batch, cache_len)
    if shape.kind == "prefill":
        batch = _lm_batch(cfg, shape.global_batch, shape.seq_len,
                          targets=False)
        return {"kind": "prefill",
                "args": (params_struct(cfg), batch, cache)}
    tokens = meta((shape.global_batch, 1), torch.int32)
    return {"kind": "decode", "args": (params_struct(cfg), tokens, cache)}
