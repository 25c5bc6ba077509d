"""Initializers with the distributions of the JAX package's
``models/initializers.py`` (the torch defaults the reference trains under),
drawn from an explicit ``torch.Generator`` so fresh weights are a function
of a seed:

- ``torch.nn.Linear``: U(±1/sqrt(fan_in)) for the weight and the bias;
- ``torch.nn.Conv2d``: U(±1/sqrt(fan_in)), fan_in = in_ch * kh * kw;
- ``torch.nn.Embedding``: N(0, 1);
- ``torch.nn.LSTM``: U(±1/sqrt(hidden)) for every weight and bias;
- xavier uniform, U(±sqrt(6 / (fan_in + fan_out))), for the attention input
  projection and the LM's position table;
- RelGAN's init, N(0, 1/sqrt(shape[0])) in torch layout, for every
  discriminator parameter (reference ``src/model/discriminator.py:53-57``).

Each fills a tensor in place, in a weight's torch layout ((out, in) for a
linear weight, (out, in, kh, kw) for a convolution).
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def linear_kernel_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(weight.shape[1])  # torch layout (out, in)
    return weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def linear_bias_(bias: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def embedding_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return weight.normal_(0.0, 1.0, generator=generator)


@torch.no_grad()
def lstm_(param: torch.Tensor, hidden: int, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(hidden)
    return param.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def conv_kernel_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(weight[0].numel())  # torch layout (out, in, kh, kw)
    return weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def relgan_(param: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1/sqrt(shape[0])): the OUT features of a torch (out, in) weight,
    the out channels of a conv weight, the length of a bias. The JAX package
    reads the same axis as ``shape[-1]`` of its (in, out) flax layout."""
    return param.normal_(0.0, 1.0 / math.sqrt(param.shape[0]), generator=generator)


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return weight.uniform_(-bound, bound, generator=generator)
