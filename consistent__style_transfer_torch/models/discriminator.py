"""RelGAN multi-representation CNN discriminator: the port of the JAX
package's ``models/discriminator.py::RelGANDiscriminator`` (reference
``src/model/discriminator.py``).

A bias-free linear "embedding" from vocab-sized distributions to d=128
(``embeddings``, a torch (128, V) weight), viewed as 16 slices of 8 dims; per
slice, convolutions with 300 filters each of heights 2, 3, 4, 5 spanning the
slice (``Conv2d(1, 300, (f, 8), stride=(1, 8))``), ReLU and max over time; a
highway layer; dropout 0.25; ``feature2out`` to 100, ``out2logits`` to one
logit per (sample, slice): a flat (B*16,) vector, row ``b*16 + r``. Every
parameter starts N(0, 1/sqrt(shape[0])) (RelGAN's init).

Integer input (B, L) is a row gather of the table (the reference's one-hot
product without the one-hot); soft input (B, L, V) is a product with it, and
arrives (L, B, V) with ``time_major``. The ``Conv2d`` modules hold the
weights in the reference's layout; :meth:`RelGANDiscriminator.forward`
multiplies the unfolded (f, 8) windows by them, as ``TextCNN`` does, which is
the same sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers as init
from .transformer import dropout, embed_or_project

EMBED_DIM = 128
NUM_REP = 16
FILTER_SIZES = (2, 3, 4, 5)
NUM_FILTERS = (300, 300, 300, 300)
FEATURE_DIM = sum(NUM_FILTERS)
EMB_DIM_SINGLE = EMBED_DIM // NUM_REP
P_DROP = 0.25


class RelGANDiscriminator(nn.Module):
    def __init__(self, n_vocab: int, p_drop: float = P_DROP, seed: int = 0):
        super().__init__()
        self.p_drop = p_drop
        self.embeddings = nn.Linear(n_vocab, EMBED_DIM, bias=False)
        self.convs = nn.ModuleList(
            nn.Conv2d(1, n, (f, EMB_DIM_SINGLE), stride=(1, EMB_DIM_SINGLE))
            for n, f in zip(NUM_FILTERS, FILTER_SIZES))
        self.highway = nn.Linear(FEATURE_DIM, FEATURE_DIM)
        self.feature2out = nn.Linear(FEATURE_DIM, 100)
        self.out2logits = nn.Linear(100, 1)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            init.relgan_(p, generator)

    def forward(self, inp, generator=None, time_major: bool = False):
        """inp: ids (B, L), or soft (B, L, V) ((L, B, V) with
        ``time_major``) -> logits (B*16,)."""
        e = embed_or_project(inp, self.embeddings.weight.t(), time_major)  # (B, L, 128)
        B, L = e.shape[0], e.shape[1]
        # (B, L, 16, 8) -> (B*16, L, 8): each slice becomes a row of its own
        e = e.reshape(B, L, NUM_REP, EMB_DIM_SINGLE).transpose(1, 2)
        e = e.reshape(B * NUM_REP, L, EMB_DIM_SINGLE)
        pools = []
        for conv, f in zip(self.convs, FILTER_SIZES):
            # windows (B*16, L-f+1, f*8) in the weight's (f, 8) order
            windows = e.unfold(1, f, 1).transpose(2, 3).flatten(2)
            h = F.linear(windows, conv.weight.flatten(1), conv.bias)
            pools.append(F.relu(h).amax(dim=1))
        pred = torch.cat(pools, dim=-1)  # (B*16, 1200)
        gate = self.highway(pred)
        pred = torch.sigmoid(gate) * F.relu(gate) + (1.0 - torch.sigmoid(gate)) * pred
        pred = dropout(pred, self.p_drop, self.training, generator)
        return self.out2logits(self.feature2out(pred))[:, 0]
