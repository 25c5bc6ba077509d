"""Differentiable sampling ops of the generator and the adversarial stage: the
port of the JAX package's ``ops/sampling.py``.

The straight-through estimator is the primitive the reference writes inline
(``src/model/rnn.py:52-53``): one-hot(argmax) going forward, the identity to
the input distribution going back.
"""

from __future__ import annotations

import torch


def hard_sample_st(probs: torch.Tensor) -> torch.Tensor:
    """one_hot(argmax(p)) in the forward pass, d/dp = identity in the backward
    pass (straight-through), in ``probs``' dtype."""
    hard = torch.zeros_like(probs).scatter_(-1, probs.argmax(dim=-1, keepdim=True), 1.0)
    return hard - probs.detach() + probs


def temperature_softmax(logits: torch.Tensor, tau: float) -> torch.Tensor:
    """softmax(logits / tau), the differentiable-decode relaxation (reference
    ``src/model/rnn.py:83``)."""
    return torch.softmax(logits / tau, dim=-1)
