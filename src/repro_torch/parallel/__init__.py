"""How a step is distributed (``ParallelCtx``): data-parallel size 1,
tensor parallelism on the stacked team."""
from .ctx import ParallelCtx, tp_of

__all__ = ["ParallelCtx", "tp_of"]
