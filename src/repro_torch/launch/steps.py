"""Step functions (fed-train / plain-train / prefill / decode) bound to a
config, plus the sharding assignment used by both the dry run and the
real launchers.

Port of `repro.launch.steps`.  On one device the steps take plain
tensors.  On a device mesh (`launch.mesh`) the caller places the
arguments by `arg_pspecs` (`sharding.rules.place`) and calls the step
inside `sharding.ctx.mesh_context(mesh, dp_axes_for(mesh))`: the fed
step splits its nodes over the ``spmd_axes``, and the plain step pins
its grads to ``param_shardings`` before the update, as the reference's
``with_sharding_constraint`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import tree as tree_util
from ..core.fed_step import FedStepConfig, fed_train_step, value_and_grad
from ..models import decode_step, loss_fn, prefill
from ..models.config import ModelConfig
from ..optim import SGD
from ..sharding import (batch_pspec, cache_pspecs, ctx, fed_batch_pspec,
                        param_pspecs)

BIG_ARCHS = ("kimi-k2-1t-a32b", "qwen2-vl-72b")   # FSDP over (pod, data)


def _names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def fsdp_axes_for(cfg: ModelConfig, mesh) -> tuple:
    names = _names(mesh)
    axes = ("pod", "data") if (cfg.name in BIG_ARCHS and "pod" in names) \
        else ("data",)
    return tuple(a for a in axes if a in names)


def dp_axes_for(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def _pinned(grads, placements):
    """Grads redistributed to the params' placements (one reduce-scatter
    class move per leaf, not repeated all-reduces)."""
    def one(g, pl):
        if ctx.is_dtensor(g) and tuple(g.placements) != tuple(pl):
            return g.redistribute(g.device_mesh, pl)
        return g
    return tree_util.map(one, grads, placements)


def _placed_like(cache, ref):
    """A step's cache back in the placements its input had (the SSM
    states are replaced by each step, in the scan's layout)."""
    def one(x, r):
        if ctx.is_dtensor(x) and ctx.is_dtensor(r) \
                and tuple(x.placements) != tuple(r.placements):
            return x.redistribute(x.device_mesh, r.placements)
        return x
    return tree_util.map(one, cache, ref)


def make_step(cfg: ModelConfig, kind: str, *,
              fcfg: Optional[FedStepConfig] = None, lr: float = 1e-2,
              spmd_axes=None, param_shardings=None):
    """The step function of ``kind``, with the reference's arguments:

      fed_train:   step(params, node_batches, eval_batch, key)
                   -> (params, metrics)
      plain_train: step(params, batch) -> (params, loss)  (SGD at ``lr``)
      prefill:     step(params, batch, cache) -> (logits, cache)
      decode:      step(params, tokens, cache) -> (logits, cache)

    ``spmd_axes`` (fed_train) names the dp axes the nodes split over;
    ``param_shardings`` (plain_train) is the params' placement tree
    (`sharding.rules.shardings_for`), which the grads are pinned to.
    """
    model_loss = lambda p, b: loss_fn(p, cfg, b)  # noqa: E731

    if kind == "fed_train":
        acc_fn = lambda p, b: loss_fn(p, cfg, b)[1]["accuracy"]  # noqa: E731

        def step(params, node_batches, eval_batch, key):
            return fed_train_step(params, node_batches, eval_batch, key,
                                  loss_fn=model_loss, acc_fn=acc_fn,
                                  fcfg=fcfg, spmd_axes=spmd_axes)
        return step

    if kind == "plain_train":
        opt = SGD(lr=lr)

        def step(params, batch):
            loss, _, grads = value_and_grad(model_loss, params, batch)
            if param_shardings is not None:
                grads = _pinned(grads, param_shardings)
            with torch.no_grad():
                params, _ = opt.update(params, grads, ())
            return params, loss
        return step

    if kind == "prefill":
        def step(params, batch, cache):
            logits, out = prefill(params, cfg, batch, cache)
            return logits, _placed_like(out, cache)
        return step

    if kind == "decode":
        def step(params, tokens, cache):
            logits, out = decode_step(params, cfg, tokens, cache)
            return logits, _placed_like(out, cache)
        return step

    raise ValueError(kind)


def arg_pspecs(cfg: ModelConfig, kind: str, mesh, args) -> Tuple:
    """Specs for the step args (same structure as args)."""
    fsdp = fsdp_axes_for(cfg, mesh)
    dp = dp_axes_for(mesh)
    if kind == "fed_train":
        params, node_batches, eval_batch, key = args
        return (param_pspecs(mesh, params, fsdp),
                fed_batch_pspec(mesh, node_batches, dp),
                tree_util.map(lambda _: (), eval_batch),
                ())
    if kind == "plain_train":
        params, batch = args
        return (param_pspecs(mesh, params, fsdp),
                batch_pspec(mesh, batch, dp))
    if kind == "prefill":
        params, batch, cache = args
        return (param_pspecs(mesh, params, fsdp),
                batch_pspec(mesh, batch, dp),
                cache_pspecs(mesh, cache, dp))
    if kind == "decode":
        params, tokens, cache = args
        return (param_pspecs(mesh, params, fsdp),
                batch_pspec(mesh, tokens, dp),
                cache_pspecs(mesh, cache, dp))
    raise ValueError(kind)
