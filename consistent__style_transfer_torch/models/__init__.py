"""Models of the port: the generator (three backbones), the three pretrain
scorers and the adversarial stage's discriminator."""

from .classifier import TextCNN
from .discriminator import RelGANDiscriminator
from .generator import DenoiseSeq2Seq
from .lfm2_moe import Lfm2MoeGenerator
from .lm import TransformerLM
from .matcher import PairMatcher
from .seq2seq_transformer import TransformerSeq2Seq

__all__ = ["DenoiseSeq2Seq", "Lfm2MoeGenerator", "PairMatcher", "RelGANDiscriminator",
           "TextCNN", "TransformerLM", "TransformerSeq2Seq"]
