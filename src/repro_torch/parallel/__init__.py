"""How a step is distributed (``ParallelCtx``): data parallelism
(training) and tensor parallelism (serving) on the stacked team."""
from .ctx import ParallelCtx, tp_of

__all__ = ["ParallelCtx", "tp_of"]
