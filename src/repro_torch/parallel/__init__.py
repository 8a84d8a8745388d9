"""How a step is distributed (``ParallelCtx``): data and tensor
parallelism on the stacked team, training and serving, and the
sequence-parallel boundary operators of TP training."""
from .ctx import ParallelCtx, sp_gather, sp_scatter, tp_of

__all__ = ["ParallelCtx", "sp_gather", "sp_scatter", "tp_of"]
