"""Train-step factory: loss -> grads (microbatches accumulated) -> global
grad-norm clip -> AdamW, on one card.

The counterpart of ``repro.train.step`` at dp = tp = 1.  The train state
is ``{"params", "opt", "step"}``; ``params`` keeps the per-layer form of
``repro_torch.models.lm.unstack`` (each layer's weights their own leaves
requiring grad, views into the stacked tensors), so each layer's
gradient is its own tensor.  ``step(state, batch)`` updates the state IN
PLACE and returns it with the metrics ``loss``, ``grad_norm`` (0-dim
tensors on the device) and ``step``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve
from repro_torch.models import lm

from .grad import _A6, backward, trainable
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .tree import leaves, tree_map


def init_train_state(gen: torch.Generator, cfg, ctx, model_api,
                     opt_cfg: AdamWConfig, device=None) -> dict:
    """Parameters drawn from ``gen`` on ``device`` (None: the GPU) in
    ``ctx.param_dtype``, and a fresh optimizer state."""
    params = model_api.init(gen, cfg, dtype=ctx.param_dtype,
                            device=resolve(device))
    return train_state_from(params, ctx, opt_cfg)


def train_state_from(params: dict, ctx, opt_cfg: AdamWConfig) -> dict:
    """A train state over given (stacked or per-layer) parameters; they
    are aliased, not copied."""
    params = trainable(lm.unstack(params))
    return {"params": params, "opt": adamw_init(params, ctx, opt_cfg),
            "step": 0}


def make_train_step(cfg, ctx, model_api, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, bucket_bytes: int = 0,
                    compress: str = "none", overlap_grad_sync: bool = False,
                    clip_norm: Optional[float] = 1.0):
    """Returns ``step(state, batch) -> (state, metrics)``.  The batch's
    leading dim must divide by ``microbatches``."""
    if bucket_bytes or compress != "none" or overlap_grad_sync:
        raise NotImplementedError(f"DP gradient bucketing, compression and "
                                  f"overlap {_A6}")

    def step(state, batch):
        params = state["params"]
        ps = leaves(params)
        for p in ps:
            p.grad = None
        tokens = batch["tokens"]
        if tokens.shape[0] % microbatches:
            raise ValueError(f"batch of {tokens.shape[0]} does not split "
                             f"into {microbatches} microbatches")
        lsum = None
        for mb in tokens.chunk(microbatches):
            lmask = backward(model_api.loss_fn, params, {"tokens": mb}, ctx,
                             cfg)
            lsum = lmask if lsum is None else lsum + lmask
        with torch.no_grad():
            grads = [p.grad for p in ps]
            if microbatches > 1:
                lsum = lsum / microbatches
                for g in grads:
                    g.div_(microbatches)
            gnorm = None
            for g in grads:
                sq = torch.sum(torch.square(g.float()))
                gnorm = sq if gnorm is None else gnorm + sq
            gnorm = torch.sqrt(gnorm)
            if clip_norm is not None:
                scale = torch.clamp(
                    clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale)
            adamw_update(params, tree_map(lambda p: p.grad, params),
                         state["opt"], ctx, opt_cfg)
        for p in ps:
            p.grad = None
        state["step"] += 1
        return state, {"loss": lsum, "grad_norm": gnorm,
                       "step": state["step"]}

    return step
