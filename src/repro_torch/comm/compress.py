"""Gradient compression for DP reductions (counterpart of
``repro.comm.compress``), with optional error feedback (EF-SGD residual
accumulation, so compression error does not bias the optimizer):

  * "bf16"  cast f32 gradients to bf16 for the wire, reduce, cast back;
  * "int8"  per-PE affine quantization (the scale from the largest
            magnitude), an all_gather of the int8 payloads and of the
            scales, then each PE combines them locally (a sum of int8
            payloads would overflow);
  * "none"  the plain psum.

Leaves are stacked ``(n_pe, *leaf)``; every scale is one PE's, as inside
the reference's ``shard_map``.  All wire traffic routes through a
``Communicator`` (``comm.psum`` / ``comm.all_gather``); a bare axis name
needs ``size=`` (``bucketing.as_communicator``).  State is a tree of
residuals matching the gradient tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..tree import leaves as tree_leaves
from ..tree import tree_map, unflatten
from .bucketing import CommLike, as_communicator


@dataclasses.dataclass
class CompressionState:
    residual: Any  # tree matching the grads (or None)

    @classmethod
    def init(cls, grads_like: Any, enabled: bool) -> "CompressionState":
        if not enabled:
            return cls(residual=None)
        return cls(residual=tree_map(torch.zeros_like, grads_like))


def compressed_allreduce(grads: Any, comm_or_axis: CommLike, *,
                         scheme: str = "bf16",
                         state: Optional[CompressionState] = None,
                         mean: bool = True, size: Optional[int] = None):
    """Returns ``(reduced_grads, new_state)``."""
    comm = as_communicator(comm_or_axis, size=size)

    def _mean(x):
        return x / comm.size if mean else x

    if scheme == "none":
        return tree_map(lambda g: _mean(comm.psum(g)), grads), state

    use_ef = state is not None and state.residual is not None

    def compress_one(g, r):
        gin = g + r if r is not None else g
        if scheme == "bf16":
            wire = gin.to(torch.bfloat16)
            err = gin - wire.to(gin.dtype)
            red = comm.psum(wire).to(gin.dtype)
            return _mean(red), err
        if scheme == "int8":
            n = gin.shape[0]
            bcast = (n,) + (1,) * (gin.dim() - 1)
            amax = gin.abs().reshape(n, -1).amax(dim=1)
            scale = torch.clamp(amax, min=1e-30) / 127.0        # (n_pe,)
            q = torch.clamp(torch.round(gin / scale.reshape(bcast)),
                            -127, 127).to(torch.int8)
            deq = q.to(gin.dtype) * scale.reshape(bcast)
            err = gin - deq
            # gather the int8 payloads and the scales, combine locally
            qs = comm.all_gather(q.unsqueeze(1), axis=0, tiled=True)
            ss = comm.all_gather(scale.reshape(n, 1), axis=0, tiled=True)
            red = torch.einsum("pn...,pn->p...", qs.to(gin.dtype), ss)
            return _mean(red), err
        raise ValueError(f"unknown compression scheme '{scheme}'")

    gl = tree_leaves(grads)
    rl = tree_leaves(state.residual) if use_ef else [None] * len(gl)
    pairs = [compress_one(g, r) for g, r in zip(gl, rl)]
    out = unflatten(grads, [p[0] for p in pairs])
    if use_ef:
        return out, CompressionState(residual=unflatten(
            grads, [p[1] for p in pairs]))
    return out, state
