"""Step functions (fed-train / plain-train / prefill / decode) bound to a
config.

Port of `repro.launch.steps.make_step` on one device.  The reference's
sharding assignment (`arg_pspecs`, `fsdp_axes_for`, `dp_axes_for`,
`BIG_ARCHS`) and its `sharding` context belong to the multi-device port
(ROADMAP.md item 15): on one device there is no mesh to constrain.
"""
from __future__ import annotations

from typing import Optional

from ..core.fed_step import FedStepConfig, fed_train_step, plain_train_step
from ..models import decode_step, loss_fn, prefill
from ..models.config import ModelConfig
from ..optim import SGD


def make_step(cfg: ModelConfig, kind: str, *,
              fcfg: Optional[FedStepConfig] = None, lr: float = 1e-2):
    """The step function of ``kind``, with the reference's arguments:

      fed_train:   step(params, node_batches, eval_batch, key)
                   -> (params, metrics)
      plain_train: step(params, batch) -> (params, loss)  (SGD at ``lr``)
      prefill:     step(params, batch, cache) -> (logits, cache)
      decode:      step(params, tokens, cache) -> (logits, cache)
    """
    model_loss = lambda p, b: loss_fn(p, cfg, b)  # noqa: E731

    if kind == "fed_train":
        acc_fn = lambda p, b: loss_fn(p, cfg, b)[1]["accuracy"]  # noqa: E731

        def step(params, node_batches, eval_batch, key):
            return fed_train_step(params, node_batches, eval_batch, key,
                                  loss_fn=model_loss, acc_fn=acc_fn,
                                  fcfg=fcfg)
        return step

    if kind == "plain_train":
        opt = SGD(lr=lr)

        def step(params, batch):
            params, _, m = plain_train_step(params, (), batch,
                                            loss_fn=model_loss,
                                            optimizer=opt)
            return params, m["loss"]
        return step

    if kind == "prefill":
        def step(params, batch, cache):
            return prefill(params, cfg, batch, cache)
        return step

    if kind == "decode":
        def step(params, tokens, cache):
            return decode_step(params, cfg, tokens, cache)
        return step

    raise ValueError(kind)
