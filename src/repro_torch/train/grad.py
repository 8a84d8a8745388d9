"""Gradients at data- and tensor-parallel size 1.

The counterpart of ``repro.train.grad``.  At dp = tp = 1 the
reference's spec-driven combine is the identity (no parameter is
sharded, no replica to average over), so ``combine_grads`` returns the
gradients as they are.  The DP reduction schedules — bucketing,
compression and the nonblocking ``overlapped_grad_sync`` — raise
``NotImplementedError``: they arrive with multi-process data
parallelism (ROADMAP A6).

Gradients land in the parameters' ``.grad`` (``loss.backward()``), so
microbatches accumulate in place, in the order the reference's
``acc + g`` scan adds them.
"""
from __future__ import annotations

from typing import Any

import torch

from .tree import leaves, tree_map

_A6 = ("arrives with multi-process data parallelism and the comm "
       "layer's bucketing/compression (ROADMAP A6)")


def trainable(params: Any) -> Any:
    """The same tree of aliases (shared storage, no copy) that are leaves
    requiring grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def backward(loss_fn, params, batch, ctx, cfg) -> torch.Tensor:
    """Run ``loss_fn`` and its backward, adding the gradients into the
    parameters' ``.grad``.  Returns the detached loss."""
    loss = loss_fn(params, batch, ctx, cfg, for_grad=True)
    loss.backward()
    return loss.detach()


def overlapped_grad_sync(grads: Any, comm, *, bucket_bytes: int = 0,
                         mean: bool = True) -> Any:
    raise NotImplementedError(f"overlapped_grad_sync {_A6}")


def combine_grads(grads: Any, specs: Any, ctx, *, bucket_bytes: int = 0,
                  compress: str = "none", comp_state=None,
                  overlap: bool = False):
    """Complete replica-local grads: the identity at dp = tp = 1 (the
    context admits no other sizes)."""
    del specs, ctx
    if bucket_bytes or compress != "none" or overlap:
        raise NotImplementedError(f"bucketed, compressed and overlapped "
                                  f"gradient reductions {_A6}")
    return grads, comp_state


def loss_and_grad(loss_fn, params, batch, ctx, cfg, specs=None,
                  **combine_kw):
    """value_and_grad: ``(display_loss, grads, comp_state)``.  The display
    loss ``dp_comm.pmean(tp_comm.psum(loss))`` is the loss at size 1."""
    for p in leaves(params):
        p.grad = None
    loss = backward(loss_fn, params, batch, ctx, cfg)
    grads = tree_map(lambda p: p.grad, params)
    grads, comp_state = combine_grads(grads, specs, ctx, **combine_kw)
    return loss, grads, comp_state
