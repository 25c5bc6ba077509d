"""Post-LN Transformer encoder with ``nn.TransformerEncoderLayer`` semantics,
the backbone of the pair matcher and the LM denoiser: the port of the JAX
package's ``models/transformer.py`` (reference ``src/model/mlm.py:20-22``,
``src/model/match.py:18-20``). Per layer: MHA -> dropout -> residual ->
LayerNorm(1e-5); FFN(2048, relu) -> dropout -> residual -> LayerNorm, with
dropout on the attention probabilities too.

The attribute names are the reference's state-dict keys
(``layers.{i}.self_attn.in_proj_weight``, ``...self_attn.out_proj.weight``,
``linear1``, ``linear2``, ``norm1``, ``norm2``). A module of the port's own
rather than ``nn.TransformerEncoderLayer``, because dropout here draws from
an explicit ``torch.Generator`` (:func:`dropout`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers as init


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with flax's rule (keep w.p. 1-p, scale by 1/(1-p)),
    its mask drawn from ``generator`` (the global generator when None). The
    identity when not ``training``."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def embed_or_project(x: torch.Tensor, table: torch.Tensor, time_major: bool = False):
    """Dual input path of every scorer: integer ids -> row gather; soft
    distributions (B, L, V) -> ``x @ table`` (one-hot @ table without the
    one-hot). ``time_major``: a soft input arrives (L, B, V), is projected
    first and the (L, B, d) result transposed to batch-major; ids are always
    batch-major."""
    if not torch.is_floating_point(x):
        return F.embedding(x.long(), table)
    out = x @ table
    return out.transpose(0, 1) if time_major else out


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, p_drop: float = 0.1):
        super().__init__()
        self.d_model, self.n_heads, self.p_drop = d_model, n_heads, p_drop
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.d_model
        init.xavier_uniform_(self.in_proj_weight, d, 3 * d, generator)
        self.in_proj_bias.zero_()
        init.linear_kernel_(self.out_proj.weight, generator)
        init.linear_bias_(self.out_proj.bias, d, generator)

    def forward(self, x, generator=None):
        B, L, d = x.shape
        h, hd = self.n_heads, d // self.n_heads
        q, k, v = (t.reshape(B, L, h, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).split(d, dim=-1))
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        attn = dropout(scores.softmax(dim=-1), self.p_drop, self.training, generator)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, L, d))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int = 2048, p_drop: float = 0.1):
        super().__init__()
        self.p_drop = p_drop
        self.self_attn = MultiHeadSelfAttention(d_model, n_heads, p_drop)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.self_attn.reset_parameters(generator)
        for lin in (self.linear1, self.linear2):
            init.linear_kernel_(lin.weight, generator)
            init.linear_bias_(lin.bias, lin.in_features, generator)
        for norm in (self.norm1, self.norm2):
            norm.reset_parameters()

    def forward(self, x, generator=None):
        drop = lambda t: dropout(t, self.p_drop, self.training, generator)  # noqa: E731
        x = self.norm1(x + drop(self.self_attn(x, generator)))
        y = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm2(x + drop(y))


class TransformerEncoder(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_heads: int, d_ff: int = 2048,
                 p_drop: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads, d_ff, p_drop)
                                    for _ in range(n_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator)
        return x
