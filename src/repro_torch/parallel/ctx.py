"""ParallelCtx — the static description of how a training step runs.

The counterpart of ``repro.parallel.ctx.ParallelCtx`` at data- and
tensor-parallel size 1, the sizes at which the reference's
communicators are identities: the loss display
``dp_comm.pmean(tp_comm.psum(x))`` is ``x``, sequence-parallel gathers
and scatters are no-ops, and gradients need no combine.  Sizes above 1
raise ``NotImplementedError``: multi-process data parallelism, the
bucketed/compressed reductions and tensor parallelism arrive with
ROADMAP A5, A6 and A7.

``attn_impl`` takes the place of the reference's ``use_pallas`` (which
the reference declares and never reads): ``"kernel"`` runs the flash
kernel in the attention forward on a CUDA tensor, ``"ref"`` the plain
PyTorch version — the serving engine's switch of the same name.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    dp_size: int = 1
    tp_size: int = 1
    remat: bool = True                  # per-layer activation checkpoint
    attn_impl: str = "kernel"           # | "ref" (counterpart of use_pallas)
    ce_mode: str = "vocab_parallel"     # | "gathered" (naive full logits)
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    ce_chunk: int = 4096

    def __post_init__(self):
        if self.dp_size != 1 or self.tp_size != 1:
            raise NotImplementedError(
                f"repro_torch trains on one card (dp = tp = 1), got "
                f"dp={self.dp_size}, tp={self.tp_size}: data parallelism "
                f"and its reductions arrive with ROADMAP A5/A6, tensor "
                f"parallelism with A7")
        if self.attn_impl not in ("kernel", "ref"):
            raise ValueError(f"attn_impl must be 'kernel' or 'ref', got "
                             f"{self.attn_impl!r}")
        if self.ce_mode not in ("vocab_parallel", "gathered"):
            raise ValueError(f"ce_mode must be 'vocab_parallel' or "
                             f"'gathered', got {self.ce_mode!r}")
