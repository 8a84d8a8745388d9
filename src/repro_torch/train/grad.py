"""Gradients on the stacked data-parallel team, and the DP reductions.

The counterpart of ``repro.train.grad``.  The reference runs one replica
per device under ``shard_map``; here every replica runs on one card, in
turn, on its contiguous block of the global batch's rows (the rows
``P("data")`` gives it), and its gradient lands in its own row of a
stacked ``(dp, *leaf)`` buffer (``replica_grads``): before replica ``r``
runs, each parameter's ``.grad`` is row ``r``'s view, so ``backward``
accumulates its microbatches there in place, in the order the
reference's ``acc + g`` scan adds them.  The buffers have the
reference's tree layout (``tree.ref_tree``: one leaf per stacked block
weight, ``(dp, n_layers, *shape)``), so the bucket plans, and the
chunks ZeRO-1 owns, are the reference's.

``combine_grads`` then reduces the rows through ``ctx.dp_comm`` by one
of the reference's four schedules (compressed, overlapped, bucketed,
per-leaf mean); every reduced row equals row 0.  ``overlapped_grad_sync``
is the paper's §3.2 nonblocking pattern: one ``allreduce_nbi`` per
bucket (or leaf) on a ``CommQueue``, in backward-walk order, drained by
one ``quiet()``, in place.  Under the reference's ``jax.grad`` every
cotangent exists before the first issue, and here the backward has
ended too: the overlap is a schedule freedom, bit-identical to the
blocking path.  At
dp = 1 nothing is reduced, as in the reference.  At tp > 1
``tp_complete`` first sums every replicated leaf's per-PE partial
gradient over TP (the reference's ``tp_fix``): the norms, the router,
the gates, and in the ctx attention layout every attention weight, each
PE's gradient covering only its own tokens or heads.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.comm.bucketing import (leaf_metas, pack, plan_buckets,
                                        unpack_bucket)
from repro_torch.tree import leaves, ref_groups, ref_tree, tree_map


def trainable(params: Any) -> Any:
    """The same tree of aliases (shared storage, no copy) that are leaves
    requiring grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def backward(loss_fn, params, batch, ctx, cfg) -> torch.Tensor:
    """Run ``loss_fn`` and its backward, adding the gradients into the
    parameters' ``.grad``.  Returns the detached loss (at tp > 1 every
    PE's masked loss, (tp,), each PE seeded with one, as ``jax.grad``
    seeds every device)."""
    loss = loss_fn(params, batch, ctx, cfg, for_grad=True)
    loss.sum().backward()
    return loss.detach()


def grad_rows(params: dict, dp: int) -> dict:
    """Zeroed gradient rows in the reference's layout: each leaf
    ``(dp, n_layers, *shape)`` for a block weight, ``(dp, *shape)`` for
    any other, in f32 on the parameters' device."""
    def zeros(g):
        t = g[0] if isinstance(g, list) else g
        lead = (dp, len(g)) if isinstance(g, list) else (dp,)
        return torch.zeros(lead + tuple(t.shape), dtype=torch.float32,
                           device=t.device)
    return ref_tree(params, zeros)


def _pairs(params: dict, rows: dict, r: int):
    """(parameter, its slot in row ``r`` of the gradient buffers)."""
    for group, buf in zip(ref_groups(params), leaves(rows)):
        if isinstance(group, list):
            for li, p in enumerate(group):
                yield p, buf[r, li]
        else:
            yield group, buf[r]


def _bind(params: dict, rows: dict, r: int) -> None:
    """Point every f32 parameter's ``.grad`` at row ``r`` of its buffer
    (autograd then accumulates into it in place); a bf16 parameter's
    gradient is folded in by ``_fold``."""
    for p, slot in _pairs(params, rows, r):
        if p.dtype == slot.dtype:
            p.grad = slot


def _fold(params: dict, rows: dict, r: int) -> None:
    """Add a bf16 parameter's microbatch gradient into its f32 slot of
    row ``r`` and clear it: bf16 gradients accumulated in f32, as the
    reference's microbatch scan does.  At one microbatch the reference
    keeps them bf16 (its TP psum and DP mean round to bf16); the rows
    here stay f32, the more exact of the two."""
    with torch.no_grad():
        for p, slot in _pairs(params, rows, r):
            if p.dtype != slot.dtype and p.grad is not None:
                slot.add_(p.grad)
                p.grad = None


def _split(batch: dict, n: int) -> list:
    """``n`` batches of consecutive rows, every key split alike (the
    reference's ``jax.tree.map(split, batch)``)."""
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def replica_grads(loss_fn, params, batch, ctx, cfg, microbatches: int = 1):
    """Every DP replica's loss and gradient on its block of ``batch``
    (the global batch: a dict whose every value — ``tokens``, and
    ``frames`` or ``img_embeds`` — is split by rows alike), its
    microbatches accumulated: ``(lmask (dp,), rows)`` with ``rows`` the
    stacked ``grad_rows`` (at tp > 1 ``lmask`` is (dp, tp)).  Each
    replica's loss and gradient are its microbatches' mean, as the
    reference's scan gives them.  The parameters' ``.grad`` is None
    after."""
    dp = ctx.dp_size
    n = batch["tokens"].shape[0]
    if n % (dp * microbatches):
        raise ValueError(f"batch of {n} does not split into "
                         f"{dp} replicas x {microbatches} microbatches")
    for k, v in batch.items():
        if v.shape[0] != n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, the "
                             f"tokens {n}")
    ps = leaves(params)
    rows = grad_rows(params, dp)
    lmask = []
    try:
        for r, block in enumerate(_split(batch, dp)):
            _bind(params, rows, r)
            lsum = None
            for mb in _split(block, microbatches):
                lm = backward(loss_fn, params, mb, ctx, cfg)
                _fold(params, rows, r)
                lsum = lm if lsum is None else lsum + lm
            lmask.append(lsum / microbatches if microbatches > 1 else lsum)
    finally:
        for p in ps:
            p.grad = None
    if microbatches > 1:
        with torch.no_grad():
            for g in leaves(rows):
                g.div_(microbatches)
    return torch.stack(lmask), rows


def overlapped_grad_sync(grads: Any, comm, *, bucket_bytes: int = 0,
                         mean: bool = True) -> Any:
    """DP gradient reduction through the paper's nonblocking pipeline.

    The reductions are issued ``allreduce_nbi`` onto ``comm.queue()`` in
    reverse leaf order, the order the backward walk produces gradients
    (output layer first), and nothing completes until the single
    ``quiet()``.  Bucketing follows the same plan as the blocking
    ``bucketed_allreduce`` (``comm.bucketing.plan_buckets``) and the
    reductions deliver in issue order at the drain, so the result is
    bit-identical to the blocking path with equal ``bucket_bytes``.
    Leaves are stacked ``(n_pe, *leaf)``.

    The reduction is IN PLACE (unlike the reference's pure function):
    each delivery writes its sum back into what was issued — a leaf, or
    a bucket, which is the leaf itself when the leaf fills it alone
    (``bucketing.pack``) — and a packed bucket's sums are copied back
    into its leaves.  Every leaf of ``grads`` holds its reduced value
    after the drain and ``grads`` is returned: at full width a second
    copy of the stacked gradient rows would not fit beside them."""
    gl = leaves(grads)
    if not gl or comm.size == 1:
        return grads

    def reduce_into(x):
        return x.copy_(comm.psum(x))

    q = comm.queue()
    if bucket_bytes:
        metas = leaf_metas(gl)
        pending = [(bucket, q.allreduce_nbi(pack(gl, bucket), reduce_into))
                   for bucket in reversed(plan_buckets(metas, bucket_bytes))]
        q.quiet()                                # the single drain point
        reduced = [None] * len(gl)
        for bucket, res in pending:
            unpack_bucket(res.value(), bucket, metas, reduced)
            for i in bucket:
                if reduced[i].data_ptr() != gl[i].data_ptr():
                    gl[i].copy_(reduced[i])      # out of a packed copy
    else:
        for g in reversed(gl):
            q.allreduce_nbi(g, reduce_into)
        q.quiet()                                # the single drain point
    if mean:
        for g in gl:
            g.div_(comm.size)
    return grads


def tp_axis(group) -> int:
    """The PE axis of a gradient row's leaf in the TP training layout:
    behind the DP and layer axes of a block leaf (a ``ref_groups`` list),
    behind the DP axis of any other."""
    return 2 if isinstance(group, list) else 1


@torch.no_grad()
def tp_complete(grads: Any, params: Any, specs: Any, ctx) -> Any:
    """The reference's ``tp_fix``: each leaf ``specs`` (``registry.
    tp_specs``, in the reference's stacked tree) marks replicated (None)
    has its PE rows psummed through ``ctx.tp_comm``, IN PLACE; a
    TP-sharded leaf is left as it is.  ``params`` gives each leaf's
    layout (``ref_groups``).  The identity at tp = 1."""
    if ctx.tp_size == 1:
        return grads
    for group, g, spec in zip(ref_groups(params), leaves(grads),
                              leaves(specs)):
        if spec is None:
            ax = tp_axis(group)
            g.copy_(ctx.tp_comm.psum(g.movedim(ax, 0)).movedim(0, ax))
    return grads


def combine_grads(grads: Any, specs: Any, ctx, *, bucket_bytes: int = 0,
                  compress: str = "none", comp_state=None,
                  overlap: bool = False, params: Any = None):
    """Complete the stacked replica grads per spec at tp > 1
    (``tp_complete``, which needs the ``params`` they belong to), then
    DP-mean them (overlapped through the nonblocking pipeline when
    ``overlap``): the reference's four branches, taken at dp > 1 only.
    ``specs`` is ``registry.tp_specs``' tree, read at tp > 1 only."""
    if ctx.tp_size > 1:
        if params is None or specs is None:
            raise ValueError("combine_grads at tp > 1 completes the grads "
                             "per spec: pass specs= and params=")
        tp_complete(grads, params, specs, ctx)
    if ctx.dp_size > 1:
        comm = ctx.dp_comm
        if compress != "none":
            grads, comp_state = comm.compressed_psum(
                grads, scheme=compress, state=comp_state, mean=True)
        elif overlap:
            grads = overlapped_grad_sync(grads, comm,
                                         bucket_bytes=bucket_bytes, mean=True)
        elif bucket_bytes:
            grads = comm.bucketed_psum(grads, bucket_bytes=bucket_bytes)
            grads = tree_map(lambda g: g / ctx.dp_size, grads)
        else:
            grads = comm.tree_pmean(grads)
    return grads, comp_state


def display_loss(lmask: torch.Tensor, ctx) -> torch.Tensor:
    """The reference's display value ``dp_comm.pmean(tp_comm.psum(
    lmask))`` of the stacked single-seed losses: (dp,) at tp = 1, (dp,
    tp) at tp > 1 (the same on every PE)."""
    if ctx.tp_size > 1:
        lmask = ctx.tp_comm.psum(lmask.T).T
    return ctx.dp_comm.pmean(lmask)


def loss_and_grad(loss_fn, params, batch, ctx, cfg, specs=None,
                  **combine_kw):
    """value_and_grad with the single-seed loss and the spec combine:
    ``(display_loss, grads, comp_state)``, each stacked over the DP
    replicas (and PEs) as the reference's devices return them: the loss
    ``display_loss`` (dp,) or (dp, tp), the grads in the reference's
    layout ``(dp, ...)`` (``grad_rows``; completed over TP per ``specs``
    — ``registry.tp_specs(cfg, tp)`` when not given — and reduced at
    dp > 1).  ``batch`` is the global batch, each replica taking its
    block of rows."""
    if ctx.tp_size > 1 and specs is None:
        from repro_torch.models.registry import tp_specs
        specs = tp_specs(cfg, ctx.tp_size)
    lmask, grads = replica_grads(loss_fn, params, batch, ctx, cfg)
    loss = display_loss(lmask, ctx)
    with torch.no_grad():
        grads, comp_state = combine_grads(grads, specs, ctx, params=params,
                                          **combine_kw)
    return loss, grads, comp_state
