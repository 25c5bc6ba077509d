"""Padding helper of the JAX package's ``data/noise.py``. The noising ops
(transfer noise, random permutation) belong to training and come with the
warmup/pretrain slices."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def align(
    sentences: Sequence[Sequence[int]], pad_value: int, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Truncate + right-pad to a *static* ``max_len``. Returns
    (ids (B, max_len) int32, lengths (B,) int32)."""
    B = len(sentences)
    ids = np.full((B, max_len), pad_value, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(sentences):
        s = list(s)[:max_len]
        ids[i, : len(s)] = s
        lengths[i] = len(s)
    return ids, lengths
