"""Train-step factory: each DP replica's loss and grads (microbatches
accumulated) -> the DP reduction -> global grad-norm clip -> AdamW, on
one card.

The counterpart of ``repro.train.step``.  At ``ctx.dp_size`` > 1 the
replicas run on the stacked team (``grad.replica_grads``): each takes
its contiguous block of the global batch's rows and runs its own
microbatch loop, its gradient in its own row of the stacked buffers.  Under ZeRO-0 the rows are reduced by the
reference's schedules (compressed without error feedback, overlapped,
bucketed, or the per-leaf mean; ``grad.combine_grads``) and row 0 feeds
the update, as the reference's ``out_specs=P()`` returns replica 0;
under ZeRO-1 the flags are ignored, as there: each replica's gradient is
clipped by its own norm and reduce-scattered inside ``adamw_update``,
and the ``grad_norm`` shown is replica 0's.  The displayed loss is
``dp_comm.pmean`` of the replicas' losses (row 0).

At ``ctx.tp_size`` > 1 (every family, either attention layout) the
parameters take
the TP layout (``weights.shard_for_tp``: every leaf stacked per PE),
each replica is one TP-stacked forward and backward of the
single-seed loss, the replicated leaves' rows are completed through
``ctx.tp_comm`` (``grad.tp_complete``, per ``registry.tp_specs``), and
the grad norm and clip follow the reference exactly: each PE's norm is
over its own LOCAL leaves (its shards and its copies of the replicated
leaves), with no TP reduction, so each PE clips by its own norm and
the PEs' copies of a replicated leaf part after a clipped step, as the
reference's do (ROADMAP §C).  One norm per (replica row, PE); the
``grad_norm`` shown is replica 0's PE 0's, the loss ``dp_comm.pmean(
tp_comm.psum(lmask))``'s.  AdamW (and ZeRO-1's chunks, per PE) runs on
the shards.

The train state is ``{"params", "opt", "step"}``; ``params`` keeps the
per-layer form of ``repro_torch.models.lm.unstack`` (each layer's
weights their own leaves requiring grad, views into the stacked
tensors).  ``step(state, batch)`` takes the global batch, updates the
state IN PLACE and returns it with the metrics ``loss``, ``grad_norm``
(0-dim tensors on the device) and ``step``.

``state_to_tree`` gives the state in the reference's layout, the tree a
checkpoint holds, and ``state_from_tree`` loads such a tree (the port's
checkpoint or the reference's) back into a live state.  At tp > 1 both
take the ctx and the config and write / read the reference's GLOBAL
tree
(``weights.unshard`` / ``shard_leaf``; ZeRO-1's chunks in the mesh's
device order, data-major), so a TP checkpoint resumes at tp = 1 and in
the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.models.registry import tp_specs
from repro_torch.tree import STACKED, ref_groups
from repro_torch.parallel import tp_of
from repro_torch.weights import map_tp, shard_for_tp, shard_leaf, unshard_leaf

from .grad import (combine_grads, display_loss, replica_grads, tp_axis,
                   tp_complete, trainable)
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .tree import leaves, ref_tree, tree_map


def init_train_state(gen: torch.Generator, cfg, ctx, model_api,
                     opt_cfg: AdamWConfig, device=None) -> dict:
    """Parameters drawn from ``gen`` on ``device`` (None: the GPU) in
    ``ctx.param_dtype``, and a fresh optimizer state."""
    params = model_api.init(gen, cfg, dtype=ctx.param_dtype, tp=ctx.tp_size,
                            device=resolve(device))
    return train_state_from(params, ctx, opt_cfg, cfg)


def _specs(ctx, cfg):
    """The TP specs a tp > 1 step completes by (``registry.tp_specs``);
    None at tp = 1."""
    if ctx.tp_size == 1:
        return None
    if cfg is None:
        raise ValueError("training at tp > 1 needs the config (its TP "
                         "specs)")
    return tp_specs(cfg, ctx.tp_size)


def train_state_from(params: dict, ctx, opt_cfg: AdamWConfig,
                     cfg=None) -> dict:
    """A train state over given (stacked or per-layer) parameters; they
    are aliased, not copied.  At tp > 1 ``params`` are the global
    (stacked) ones, or already in the TP layout, and ``cfg`` their
    config: the state holds them in the TP layout
    (``weights.shard_for_tp``: row and expert splits alias the global
    tensors, the rest are new)."""
    if _specs(ctx, cfg) is not None:
        params = shard_for_tp(params, cfg, ctx.tp_size)
    params = trainable(lm.unstack(params))
    return {"params": params, "opt": adamw_init(params, ctx, opt_cfg),
            "step": 0}


def make_train_step(cfg, ctx, model_api, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, bucket_bytes: int = 0,
                    compress: str = "none", overlap_grad_sync: bool = False,
                    clip_norm: Optional[float] = 1.0):
    """Returns ``step(state, batch) -> (state, metrics)``.  The global
    batch (``tokens``, and whisper's ``frames`` or the vlm's
    ``img_embeds``, each split by rows with the tokens) must have a
    leading dim that divides by dp x ``microbatches``."""
    specs = _specs(ctx, cfg)
    dp, tp = ctx.dp_size, ctx.tp_size
    # zero-1 at dp > 1: the clip is replica-local, before the scatter
    local = opt_cfg.zero == 1 and dp > 1

    def step(state, batch):
        params = state["params"]
        lmask, grads = replica_grads(model_api.loss_fn, params, batch, ctx,
                                     cfg, microbatches)
        with torch.no_grad():
            if opt_cfg.zero == 0:
                grads, _ = combine_grads(grads, specs, ctx, params=params,
                                         bucket_bytes=bucket_bytes,
                                         compress=compress,
                                         overlap=overlap_grad_sync)
            else:                   # zero-1 reduce-scatters over DP itself
                tp_complete(grads, params, specs, ctx)
            rows = dp if local else 1       # the rows the update reads
            gnorm = _clip(grads, ref_groups(params), rows, tp, clip_norm)
            adamw_update(params, grads, state["opt"], ctx, opt_cfg)
            loss = display_loss(lmask, ctx).reshape(dp, -1)[0, 0]
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm[0, 0],
                       "step": state["step"]}

    return step


def _clip(grads, groups, rows: int, tp: int, clip_norm) -> torch.Tensor:
    """The reference's global grad norm and clip on the gradient rows the
    update reads: one norm per (row, PE), over that PE's local leaves in
    leaf order (at tp > 1 with no TP reduction: each PE clips by its own
    norm, as the reference's); returns the norms (rows, tp)."""
    gnorm = None
    for group, g in zip(groups, leaves(grads)):
        gr = g[:rows].float()
        if tp > 1:
            gr = gr.movedim(tp_axis(group), 1)
        sq = torch.sum(torch.square(gr).reshape(rows, tp, -1), dim=2)
        gnorm = sq if gnorm is None else gnorm + sq
    gnorm = torch.sqrt(gnorm)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        for group, g in zip(groups, leaves(grads)):
            shape = [rows] + [1] * (g.dim() - 1)
            if tp > 1:
                shape[tp_axis(group)] = tp
            g[:rows].mul_(scale.view(shape))
    return gnorm


def _layered(tree: dict) -> bool:
    """Whether a live tree holds per-layer groups (params, or ZeRO-0's
    m / v / master), not ZeRO-1's flat chunks."""
    return any(isinstance(tree.get(k), list) for k in STACKED)


def state_to_tree(state: dict, device=None, cfg=None, ctx=None) -> dict:
    """The train state in the reference's layout: ``{"params", "opt":
    {"m", "v", "count"[, "master"]}, "step"}`` with each per-layer group
    (``tree.STACKED``; a hybrid's ``shared`` block is one dict in both)
    restacked on a leading layer axis (under ZeRO-1 each
    leaf's ``(dp, c)`` chunks concatenated into the reference's ``(dp * c,)``
    global view, the layout ``adamw_state_specs`` declares), ``count``
    and ``step`` int32 0-d tensors — leaf for leaf the reference's train
    state, in its leaf order.  At tp > 1 (the state's ``ctx`` and
    ``cfg``) the global tree: each sharded leaf's PE chunks concatenated, PE 0's copy of a
    replicated one (``weights.unshard_leaf``), ZeRO-1's ``(dp, tp, c)``
    chunks in the mesh's device order.  The tensors are new, on
    ``device`` (None: each leaf's own; "meta" for a template that holds
    the structure alone)."""
    opt = state["opt"]
    spec = _specs(ctx, cfg) if tp_of(ctx) > 1 else None

    def stack(g):
        if not isinstance(g, list):
            return g.detach().to(device or g.device, copy=True)
        out = torch.empty((len(g),) + tuple(g[0].shape), dtype=g[0].dtype,
                          device=device or g[0].device)
        for li, t in enumerate(g):
            out[li].copy_(t.detach())
        return out

    def ref(tree):
        if not _layered(tree):
            return tree_map(lambda t: stack(t).reshape(-1), tree)  # ZeRO-1
        out = ref_tree(tree, stack)
        if spec is not None:
            out = map_tp(unshard_leaf, out, spec)
        return out

    dev = device or opt["m"]["embed"]["table"].device
    o = {k: ref(opt[k]) for k in ("m", "v", "master") if k in opt}
    o["count"] = torch.tensor(opt["count"], dtype=torch.int32, device=dev)
    return {"params": ref(state["params"]), "opt": o,
            "step": torch.tensor(state["step"], dtype=torch.int32,
                                 device=dev)}


@torch.no_grad()
def state_from_tree(state: dict, tree: dict, cfg=None, ctx=None) -> dict:
    """Load ``tree`` (the reference's layout: ``state_to_tree``'s, or a
    train state the JAX package checkpointed) into the live ``state`` in
    place: every tensor copied into its counterpart (layer ``li`` of a
    stacked leaf into layer ``li``'s tensor), ``count`` and ``step`` as
    ints.  The two must hold the same leaves in the same dtypes.  At
    tp > 1 (the state's ``ctx`` and ``cfg``) the global tree is split per PE first
    (``weights.shard_leaf``), so a checkpoint of any TP size (or the
    reference's) loads.  Returns ``state``."""
    tp = tp_of(ctx)
    if tp > 1:
        spec = _specs(ctx, cfg)

        def split(dst, src):
            if not _layered(dst):
                return src                                   # ZeRO-1
            return map_tp(lambda w, a, blk: shard_leaf(w, a, blk, tp), src,
                          spec)
        tree = {**tree, "params": split(state["params"], tree["params"]),
                "opt": {k: split(state["opt"][k], v)
                        if k in ("m", "v", "master") and k in state["opt"]
                        else v for k, v in tree["opt"].items()}}

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
            if not isinstance(d, list):
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
