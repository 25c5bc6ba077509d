"""Models of the port: the generator (two backbones), the three pretrain
scorers and the adversarial stage's discriminator."""

from .classifier import TextCNN
from .discriminator import RelGANDiscriminator
from .generator import DenoiseSeq2Seq
from .lm import TransformerLM
from .matcher import PairMatcher
from .seq2seq_transformer import TransformerSeq2Seq

__all__ = ["DenoiseSeq2Seq", "PairMatcher", "RelGANDiscriminator", "TextCNN", "TransformerLM",
           "TransformerSeq2Seq"]
