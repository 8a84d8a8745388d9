"""Train-step factory: loss -> grads (microbatches accumulated) -> global
grad-norm clip -> AdamW, on one card.

The counterpart of ``repro.train.step`` at dp = tp = 1 (a ctx at tp > 1
raises ``NotImplementedError``: TP training is ROADMAP A10).  The train state
is ``{"params", "opt", "step"}``; ``params`` keeps the per-layer form of
``repro_torch.models.lm.unstack`` (each layer's weights their own leaves
requiring grad, views into the stacked tensors), so each layer's
gradient is its own tensor.  ``step(state, batch)`` updates the state IN
PLACE and returns it with the metrics ``loss``, ``grad_norm`` (0-dim
tensors on the device) and ``step``.

``state_to_tree`` gives the state in the reference's layout, the tree a
checkpoint holds, and ``state_from_tree`` loads such a tree (the port's
checkpoint or the reference's) back into a live state.
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


def _check_tp(ctx) -> None:
    if ctx.tp_size != 1:
        raise NotImplementedError(
            f"repro_torch trains at tp = 1, got tp={ctx.tp_size}: "
            f"tensor-parallel training arrives with ROADMAP A10")


def train_state_from(params: dict, ctx, opt_cfg: AdamWConfig) -> dict:
    """A train state over given (stacked or per-layer) parameters; they
    are aliased, not copied."""
    _check_tp(ctx)
    params = trainable(lm.unstack(params))
    return {"params": params, "opt": adamw_init(params, ctx, opt_cfg),
            "step": 0}


def make_train_step(cfg, ctx, model_api, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, bucket_bytes: int = 0,
                    compress: str = "none", overlap_grad_sync: bool = False,
                    clip_norm: Optional[float] = 1.0):
    """Returns ``step(state, batch) -> (state, metrics)``.  The batch's
    leading dim must divide by ``microbatches``."""
    _check_tp(ctx)
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


def state_to_tree(state: dict, device=None) -> dict:
    """The train state in the reference's layout: ``{"params", "opt":
    {"m", "v", "count"[, "master"]}, "step"}`` with each per-layer block
    list restacked on a leading layer axis (under ZeRO-1 the stacked m /
    v / master chunks flattened, as the reference's whole-leaf chunks),
    ``count`` and ``step`` int32 0-d tensors — leaf for leaf the
    reference's train state, in its leaf order.  The tensors are new,
    on ``device`` (None: each leaf's own; "meta" for a template that
    holds the structure alone)."""
    opt = state["opt"]
    zero1 = opt["m"]["embed"]["table"].dim() == 1

    def stack(layers, flat):
        if isinstance(layers[0], dict):
            return {k: stack([lyr[k] for lyr in layers], flat)
                    for k in layers[0]}
        t0 = layers[0]
        out = torch.empty((len(layers),) + tuple(t0.shape), dtype=t0.dtype,
                          device=device or t0.device)
        for li, t in enumerate(layers):
            out[li].copy_(t.detach())
        return out.reshape(-1) if flat else out

    def restack(tree, flat=False):
        out = {k: tree_map(lambda t: t.detach().to(device or t.device,
                                                   copy=True), v)
               for k, v in tree.items() if k != "blocks"}
        out["blocks"] = stack(tree["blocks"], flat)
        return out

    dev = device or opt["m"]["embed"]["table"].device
    o = {k: restack(opt[k], zero1) for k in ("m", "v", "master") if k in opt}
    o["count"] = torch.tensor(opt["count"], dtype=torch.int32, device=dev)
    return {"params": restack(state["params"]), "opt": o,
            "step": torch.tensor(state["step"], dtype=torch.int32,
                                 device=dev)}


@torch.no_grad()
def state_from_tree(state: dict, tree: dict) -> dict:
    """Load ``tree`` (the reference's layout: ``state_to_tree``'s, or a
    train state the JAX package checkpointed) into the live ``state`` in
    place: every tensor copied into its counterpart (layer ``li`` of a
    stacked leaf into layer ``li``'s tensor), ``count`` and ``step`` as
    ints.  The two must hold the same leaves in the same dtypes.
    Returns ``state``."""
    def put(dst, src):
        if src.dtype != dst.dtype:
            raise ValueError(f"checkpoint leaf of {src.dtype} into a "
                             f"{dst.dtype} state tensor")
        dst.copy_(src.reshape(dst.shape))

    def load(dst, src):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint keys {sorted(src)} differ from "
                             f"the state's {sorted(dst)}")
        for k, d in dst.items():
            if k != "blocks":
                tree_map(put, d, src[k])
                continue
            n = len(d)
            for li, layer in enumerate(d):
                tree_map(lambda a, b: put(a, b.reshape(n, -1)[li]), layer,
                         src[k])

    opt = state["opt"]
    load(state["params"], tree["params"])
    if set(opt) != set(tree["opt"]):
        raise ValueError(f"checkpoint optimizer keys {sorted(tree['opt'])} "
                         f"differ from the state's {sorted(opt)}")
    for k in ("m", "v", "master"):
        if k in opt:
            load(opt[k], tree["opt"][k])
    opt["count"] = int(tree["opt"]["count"])
    state["step"] = int(tree["step"])
    return state
