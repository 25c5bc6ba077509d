"""Models of the port: the generator (greedy decode) and the three pretrain
scorers."""

from .classifier import TextCNN
from .generator import DenoiseSeq2Seq
from .lm import TransformerLM
from .matcher import PairMatcher

__all__ = ["DenoiseSeq2Seq", "PairMatcher", "TextCNN", "TransformerLM"]
