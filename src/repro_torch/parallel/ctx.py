"""ParallelCtx — the static description of how a step is distributed.

The counterpart of ``repro.parallel.ctx.ParallelCtx``.  Two
communicators are built in ``__post_init__`` from the sizes, ``backend``
and ``dispatch``, as the reference builds them: ``tp_comm`` over the
``"model"`` axis and ``dp_comm`` over ``dp_axes`` (``("data",)``).

Data parallelism trains on the stacked team (ROADMAP A6): the trainer
(``train.step``) runs each of ``dp_size`` replicas on its block of the
global batch, each replica's gradient in its own row of a stacked
``(dp, *leaf)`` buffer, and reduces the rows through ``dp_comm``.
Serving ignores ``dp_size``: its replicas are ``serve.StackedExec``'s
``replicas``.

Tensor parallelism serves on the stacked team (ROADMAP A7): every PE of
the TP group lives on one tensor's leading axis, and ``tp_comm`` — built
in ``__post_init__`` from ``tp_size``, ``backend`` and ``dispatch``, as
the reference builds it — reduces over that axis.  The layers take
activations ``(tp, ...)`` and weights stacked once ``(tp, ...)``
(``weights.shard_for_tp``) and call ``ctx.tp_comm.psum`` /
``top_k_merge`` where the reference does.  At ``tp_size == 1`` the
communicator is the identity and the layers take unstacked tensors,
as before; ``tp_of`` is the one test of which layout a layer takes.

The trainer runs at tp > 1 too, for every family and both attention
layouts, on the same stacked parameters as serving
(``weights.shard_for_tp``: every leaf stacked per PE, a replicated leaf
one copy a PE, so that each PE's gradient is its own row), with the
activations sequence-sharded between the layers, as the reference's
launcher sets ``sp = tp > 1``.  ``sp_gather`` and ``sp_scatter`` are the
reference's Megatron boundary operators; the layers call them only in
training (``mlp_apply`` / ``moe_apply``'s ``sp``), and the collectives
they call differentiate by their transposes (``comm.autograd``).  The
field ``sp`` is the reference's: with it off (whisper's encoder, whose
frames stay whole on every PE) ``sp_gather`` is the identity and
``sp_scatter`` a psum.  Serving and the contiguous-cache decode reduce
with a psum, as the reference's serving step with SP off.

``moe_dispatch`` picks the MoE layer's route between the TP ranks, as
the reference's field of the same name: ``"einsum"`` (every rank routes
every token, runs its own experts' share and the ranks' partial outputs
are psummed) or ``"alltoall"`` (tokens travel to their experts' owners
and back through ``tp_comm.all_to_all``).  At tp = 1 both are the same
single-rank computation.

``attn_impl`` takes the place of the reference's ``use_pallas`` (which
the reference declares and never reads): ``"kernel"`` runs the flash
kernel in the attention forward on a CUDA tensor, ``"ref"`` the plain
PyTorch version — the serving engine's switch of the same name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm import Communicator, DispatchTable, make_communicator


def tp_of(ctx) -> int:
    """The TP size a layer runs at (1 without a ctx): above 1 it takes
    the stacked ``(tp, ...)`` layout, at 1 unstacked tensors."""
    return 1 if ctx is None else ctx.tp_size


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    dp_axes: tuple = ("data",)
    dp_size: int = 1
    tp_size: int = 1
    backend: str = "xla"                # "xla" | "posh" | "pallas"
    dispatch: DispatchTable = DispatchTable()
    tp_comm: Optional[Communicator] = None   # built from the fields above
    dp_comm: Optional[Communicator] = None   # when not given explicitly
    sp: bool = True                     # sequence-parallel activations
    remat: bool = True                  # per-layer activation checkpoint
    attn_impl: str = "kernel"           # | "ref" (counterpart of use_pallas)
    ce_mode: str = "vocab_parallel"     # | "gathered" (naive full logits)
    moe_dispatch: str = "einsum"        # | "alltoall"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    ce_chunk: int = 4096

    def __post_init__(self):
        for name in ("dp_size", "tp_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.attn_impl not in ("kernel", "ref"):
            raise ValueError(f"attn_impl must be 'kernel' or 'ref', got "
                             f"{self.attn_impl!r}")
        if self.ce_mode not in ("vocab_parallel", "gathered"):
            raise ValueError(f"ce_mode must be 'vocab_parallel' or "
                             f"'gathered', got {self.ce_mode!r}")
        if self.moe_dispatch not in ("einsum", "alltoall"):
            raise ValueError(f"moe_dispatch must be 'einsum' or 'alltoall', "
                             f"got {self.moe_dispatch!r}")
        if self.tp_comm is None:
            object.__setattr__(self, "tp_comm", make_communicator(
                "model", size=self.tp_size, backend=self.backend,
                dispatch=self.dispatch, name=f"tp:{self.backend}"))
        elif self.tp_comm.size != self.tp_size:
            raise ValueError(f"tp_comm spans {self.tp_comm.size} PEs, "
                             f"tp_size is {self.tp_size}")
        if self.dp_comm is None:
            object.__setattr__(self, "dp_comm", make_communicator(
                tuple(self.dp_axes), size=self.dp_size, backend=self.backend,
                dispatch=self.dispatch, name=f"dp:{self.backend}"))
        elif self.dp_comm.size != self.dp_size:
            raise ValueError(f"dp_comm spans {self.dp_comm.size} PEs, "
                             f"dp_size is {self.dp_size}")

    def tp_rank(self, device=None) -> torch.Tensor:
        """Every TP PE's rank, along the stacked PE axis."""
        return self.tp_comm.rank(device)

    def dp_rank(self, device=None) -> torch.Tensor:
        """Every DP replica's rank, along the stacked PE axis."""
        return self.dp_comm.rank(device)

    # fields whose change invalidates each auto-built communicator, kept
    # apart so that e.g. with_(dp_size=1) keeps the tp_comm object (and
    # what its instrumentation recorded)
    _TP_COMM_FIELDS = frozenset({"tp_size", "backend", "dispatch"})
    _DP_COMM_FIELDS = frozenset({"dp_axes", "dp_size", "backend",
                                 "dispatch"})

    def with_(self, **kw) -> "ParallelCtx":
        """``dataclasses.replace`` that rebuilds a communicator when a
        field it derives from changes (unless the caller passes one)."""
        if self._TP_COMM_FIELDS & kw.keys():
            kw.setdefault("tp_comm", None)
        if self._DP_COMM_FIELDS & kw.keys():
            kw.setdefault("dp_comm", None)
        return dataclasses.replace(self, **kw)


def sp_gather(x: torch.Tensor, ctx, axis: int = 1) -> torch.Tensor:
    """Sequence-parallel gather of stacked (tp, b, t/tp, d) shards ->
    (tp, b, t, d) (``axis`` names the shard's sequence axis): the
    Megatron 'g' operator, a tiled ``all_gather``; the identity at
    tp == 1 or with ``ctx.sp`` off (every PE holds the whole sequence)."""
    if tp_of(ctx) == 1 or not ctx.sp:
        return x
    return ctx.tp_comm.all_gather(x, axis=axis, tiled=True)


def sp_scatter(x: torch.Tensor, ctx, axis: int = 1) -> torch.Tensor:
    """Sequence-parallel reduce-scatter of stacked partial sums (tp, b, t,
    d) -> reduced (tp, b, t/tp, d): the Megatron 'g-bar' operator, a
    ``psum_scatter``; the identity at tp == 1; with ``ctx.sp`` off a
    full reduction, ``psum``, as the reference's."""
    if tp_of(ctx) == 1:
        return x
    if not ctx.sp:
        return ctx.tp_comm.psum(x)
    return ctx.tp_comm.psum_scatter(x, axis=axis)
