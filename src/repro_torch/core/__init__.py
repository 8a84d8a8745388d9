"""Host substrate of the port: the symmetric heap allocator."""
from .heap import SymHandle, SymmetricHeap

__all__ = ["SymHandle", "SymmetricHeap"]
