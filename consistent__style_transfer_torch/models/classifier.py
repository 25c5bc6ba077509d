"""Kim-CNN style classifier: the port of the JAX package's
``models/classifier.py::TextCNN`` (reference ``src/model/classifier.py``).
Embedding d=128; ``Conv2d(1, 128, (k, 128))`` for k in (3, 4, 5) with time
padding k-1 at both ends, ReLU, max over time; dropout 0.5; linear to
n_class. Soft (B, L, V) inputs are projected through the embedding table.
The attribute names are the reference's keys (``embedding``, ``convs.{i}``,
``out``).

A convolution whose window spans the whole embedding width is a product of
each k-token window with the flattened kernel, and is computed so: the
``Conv2d`` modules hold the weights in the reference's layout, and
:meth:`TextCNN.forward` multiplies the unfolded windows by them. (cuDNN's
algorithm for this one-channel, full-width shape took about 17 ms per
backward call at yelp width on an H100, against well under a millisecond for
the product.)"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers as init
from .transformer import dropout, embed_or_project

D_EMBED = 128
P_DROP = 0.5
KERNELS = (3, 4, 5)
N_FILTERS = (128, 128, 128)


class TextCNN(nn.Module):
    def __init__(self, n_vocab: int, n_class: int = 2, p_drop: float = P_DROP, seed: int = 0):
        super().__init__()
        self.p_drop = p_drop
        self.embedding = nn.Embedding(n_vocab, D_EMBED)
        self.convs = nn.ModuleList(nn.Conv2d(1, n, (k, D_EMBED), padding=(k - 1, 0))
                                   for k, n in zip(KERNELS, N_FILTERS))
        self.out = nn.Linear(sum(N_FILTERS), n_class)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init.embedding_(self.embedding.weight, generator)
        for conv, k in zip(self.convs, KERNELS):
            init.conv_kernel_(conv.weight, generator)
            init.linear_bias_(conv.bias, k * D_EMBED, generator)
        init.linear_kernel_(self.out.weight, generator)
        init.linear_bias_(self.out.bias, sum(N_FILTERS), generator)

    def forward(self, x, generator=None, time_major: bool = False):
        """x: ids (B, L), or soft (B, L, V) ((L, B, V) with ``time_major``)
        -> logits (B, n_class)."""
        e = embed_or_project(x, self.embedding.weight, time_major)  # (B, L, E)
        pooled = []
        for conv, k in zip(self.convs, KERNELS):
            # time padding k-1 at both ends; windows (B, L+k-1, k*E) in the
            # weight's (k, E) order; conv.weight (n, 1, k, E) -> (n, k*E)
            windows = F.pad(e, (0, 0, k - 1, k - 1)).unfold(1, k, 1).transpose(2, 3).flatten(2)
            h = F.linear(windows, conv.weight.flatten(1), conv.bias)  # (B, L+k-1, n)
            pooled.append(F.relu(h).amax(dim=1))
        feats = torch.cat(pooled, dim=-1)
        return self.out(dropout(feats, self.p_drop, self.training, generator))
