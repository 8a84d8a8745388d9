"""How a step is distributed (``ParallelCtx``) — one card in this slice."""
from .ctx import ParallelCtx

__all__ = ["ParallelCtx"]
