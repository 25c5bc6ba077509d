"""Transformer LM denoiser / naturalness checker: the port of the JAX
package's ``models/lm.py::TransformerLM`` (reference ``src/model/mlm.py``).
A 6-layer, 8-head, d=512 bidirectional post-LN encoder (``lm.layers.{i}``)
over token + learned position embeddings (the position table, capped at
100, starts xavier-uniform), then a linear head to vocab logits. The
reference's disabled style embedding stays out."""

from __future__ import annotations

import torch
from torch import nn

from . import initializers as init
from .transformer import TransformerEncoder, embed_or_project

D_MODEL = 512
N_HEAD = 8
N_LAYER = 6
MAX_POS = 100


class TransformerLM(nn.Module):
    def __init__(self, n_vocab: int, d_model: int = D_MODEL, n_heads: int = N_HEAD,
                 n_layers: int = N_LAYER, p_drop: float = 0.1, seed: int = 0):
        super().__init__()
        self.token_embedding = nn.Embedding(n_vocab, d_model)
        self.posit_embedding = nn.Embedding(MAX_POS, d_model)
        self.lm = TransformerEncoder(n_layers, d_model, n_heads, p_drop=p_drop)
        self.fwd = nn.Linear(d_model, n_vocab)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init.embedding_(self.token_embedding.weight, generator)
        init.xavier_uniform_(self.posit_embedding.weight, MAX_POS,
                             self.posit_embedding.embedding_dim, generator)
        self.lm.reset_parameters(generator)
        init.linear_kernel_(self.fwd.weight, generator)
        init.linear_bias_(self.fwd.bias, self.fwd.in_features, generator)

    def forward(self, x, generator=None):
        """x: ids (B, L) or soft (B, L, V) -> logits (B, L, V)."""
        e = embed_or_project(x, self.token_embedding.weight)
        e = e + self.posit_embedding.weight[: e.shape[1]]
        return self.fwd(self.lm(e, generator))
