"""Loss primitives of the training stages: the port of the JAX package's
``ops/losses.py``.

As in the reference, the token-level cross entropy does NOT mask padding
(``nn.CrossEntropyLoss`` over flattened (B*L, V)): PAD positions are real
targets. ``mask`` / ``row_mask`` restrict a mean to the real rows of a padded
eval batch. Log-softmax runs in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean CE over all elements. logits (..., C), integer labels (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def softmax_cross_entropy_tokens(logits: torch.Tensor, targets: torch.Tensor,
                                 row_mask=None) -> torch.Tensor:
    """CE over token grids: logits (B, L, V), targets (B, L); mean over B*L,
    or over the rows where ``row_mask`` (B,) is nonzero."""
    flat = logits.reshape(-1, logits.shape[-1])
    if row_mask is None:
        return cross_entropy(flat, targets.reshape(-1))
    mask = row_mask[:, None].expand(targets.shape)
    return cross_entropy(flat, targets.reshape(-1), mask=mask.reshape(-1))


def mse(pred: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
    err = (pred.float() - target.float()) ** 2
    if mask is None:
        return err.mean()
    mask = mask.to(err.dtype).expand(err.shape)
    return (mask * err).sum() / torch.clamp_min(mask.sum(), 1.0)


def masked_row_mean(values: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Mean of per-row values (B,) over the rows where ``row_mask`` is nonzero."""
    values = values.float()
    row_mask = row_mask.to(values.dtype)
    return (values * row_mask).sum() / torch.clamp_min(row_mask.sum(), 1.0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy with logits in the JAX package's stable form,
    ``max(z, 0) - z t + log1p(exp(-|z|))``, mean-reduced (torch
    ``BCEWithLogitsLoss``)."""
    z = logits.float()
    return (torch.clamp_min(z, 0.0) - z * targets + torch.log1p(torch.exp(-z.abs()))).mean()
