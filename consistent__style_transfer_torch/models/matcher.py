"""BERT-style pair matcher / content-preservation regressor: the port of the
JAX package's ``models/matcher.py::PairMatcher`` (reference
``src/model/match.py``). Shared token + learned position + segment
embeddings; the two sentences are concatenated along time with segment ids
0/1 and positions restarting per segment; a 6-layer, 8-head, d=512
post-LN encoder (``matcher.layers.{i}``); max-pool over time; a linear head
to one score. Trained to regress the WMD label in pretrain."""

from __future__ import annotations

import torch
from torch import nn

from . import initializers as init
from .transformer import TransformerEncoder, embed_or_project

D_MODEL = 512
N_HEAD = 8
N_LAYER = 6
MAX_POS = 100


class PairMatcher(nn.Module):
    def __init__(self, n_vocab: int, d_model: int = D_MODEL, n_heads: int = N_HEAD,
                 n_layers: int = N_LAYER, p_drop: float = 0.1, seed: int = 0):
        super().__init__()
        self.token_embedding = nn.Embedding(n_vocab, d_model)
        self.posit_embedding = nn.Embedding(MAX_POS, d_model)
        self.segment_embedding = nn.Embedding(2, d_model)
        self.matcher = TransformerEncoder(n_layers, d_model, n_heads, p_drop=p_drop)
        self.hidden2logits = nn.Linear(d_model, 1)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for emb in (self.token_embedding, self.posit_embedding, self.segment_embedding):
            init.embedding_(emb.weight, generator)
        self.matcher.reset_parameters(generator)
        init.linear_kernel_(self.hidden2logits.weight, generator)
        init.linear_bias_(self.hidden2logits.bias, self.hidden2logits.in_features, generator)

    def _embed(self, x, segment: int, time_major: bool = False):
        e = embed_or_project(x, self.token_embedding.weight, time_major)
        return e + self.posit_embedding.weight[: e.shape[1]] + self.segment_embedding.weight[segment]

    def forward(self, x1, x2, generator=None, time_major: bool = False):
        """x1: ids (B, L1) or soft (B, L1, V) ((L1, B, V) with
        ``time_major``); x2: ids (B, L2). Returns scores (B,)."""
        h = torch.cat([self._embed(x1, 0, time_major), self._embed(x2, 1)], dim=1)
        h = self.matcher(h, generator)
        return self.hidden2logits(h.amax(dim=1))[:, 0]
