"""Models of the port. This slice carries the generator (greedy decode)."""

from .generator import DenoiseSeq2Seq

__all__ = ["DenoiseSeq2Seq"]
