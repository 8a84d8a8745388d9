"""Deterministic synthetic training data (``SyntheticLM``)."""
from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
