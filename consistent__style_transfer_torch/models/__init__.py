"""Models of the port: the generator, the three pretrain scorers and the
adversarial stage's discriminator."""

from .classifier import TextCNN
from .discriminator import RelGANDiscriminator
from .generator import DenoiseSeq2Seq
from .lm import TransformerLM
from .matcher import PairMatcher

__all__ = ["DenoiseSeq2Seq", "PairMatcher", "RelGANDiscriminator", "TextCNN", "TransformerLM"]
