"""Corpus-noising ops of the denoising objectives and the padding helper:
the port's copy of the JAX package's ``data/noise.py`` (vectorised array
forms; the reference's ``src/data_util.py``). They run on the host in numpy
from an explicit ``np.random.Generator``, so with the same generator their
outputs are bit-identical to the JAX package's.

- :func:`transfer_noise_arrays` (``src/data_util.py:32-54``): each token is
  dropped into a shared cross-sentence bag w.p. ``p``; every bagged token is
  re-inserted into a sentence chosen proportional to its original length, at
  a uniform random gap.
- :func:`rand_perm_arrays` (``src/data_util.py:56-74``): shuffles ~``p`` of
  all tokens across the batch, in place of their slots.
- :func:`align` (``src/data_util.py:25-30``): truncate + right-pad.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def transfer_noise_arrays(
    ids: np.ndarray, lens: np.ndarray, p: float, rng: np.random.Generator,
    out_len: int, pad_id: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's vectorised ``transfer_noise`` over padded ``(B, L)``
    arrays.

    Same distributional semantics as its list version (each token dropped into
    a shared bag w.p. ``p``; each bagged token re-inserted into a sentence
    chosen proportional to *original* length, at a uniformly random gap of
    that sentence), implemented with no per-token Python: the kept tokens of
    each row get integer sort keys 0..k-1 and each inserted token a uniform
    real key in (-1, k), so sorting by key realizes the insertions. Output is
    truncated to ``out_len`` (the pipeline aligns noised rows to a static
    noise_len anyway). Returns (noised ids (B, out_len), lengths (B,)).

    The only distributional difference from sequential insertion is the
    relative order of multiple tokens landing in the same gap (exchangeable
    here vs insertion-order-dependent there) — irrelevant to the denoising
    objective and below measurement noise in the pretrain/warmup losses.
    """
    B, L = ids.shape
    pos = np.arange(L)[None, :]
    valid = pos < lens[:, None]
    drop = (rng.uniform(size=(B, L)) < p) & valid
    keep = valid & ~drop

    # row-compact kept tokens (stable: kept order preserved)
    order = np.argsort(~keep, axis=1, kind="stable")
    kept_vals = np.take_along_axis(ids, order, axis=1)
    kept_n = keep.sum(axis=1).astype(np.int64)
    kept_keys = np.where(pos < kept_n[:, None], pos.astype(np.float64), np.inf)

    n_bag = int(drop.sum())
    if n_bag == 0:
        out = np.full((B, out_len), pad_id, dtype=np.int32)
        m = min(L, out_len)
        out[:, :m] = np.where(kept_keys[:, :m] < np.inf, kept_vals[:, :m], pad_id)
        return out, np.minimum(kept_n, out_len).astype(np.int32)

    # bag tokens in row-major scan order (like the reference's per-sentence
    # walk), then length-weighted target rows + uniform gap keys
    bag = ids[drop]
    total = lens.sum()
    if total <= 0:
        probs = np.full(B, 1.0 / max(B, 1))
    else:
        probs = lens.astype(np.float64) / total
    targets = rng.choice(B, size=n_bag, p=probs)
    ins_keys_flat = rng.uniform(-1.0, kept_n[targets].astype(np.float64))

    # scatter the bag into per-row slots: tokens of the same row occupy
    # consecutive columns of a (B, max_k) block
    order_bag = np.argsort(targets, kind="stable")
    tgt_sorted = targets[order_bag]
    row_counts = np.bincount(targets, minlength=B)
    max_k = int(row_counts.max())
    starts = np.zeros(B, dtype=np.int64)
    np.cumsum(row_counts[:-1], out=starts[1:])
    col = np.arange(n_bag) - starts[tgt_sorted]
    ins_vals = np.full((B, max_k), pad_id, dtype=ids.dtype)
    ins_keys = np.full((B, max_k), np.inf)
    ins_vals[tgt_sorted, col] = bag[order_bag]
    ins_keys[tgt_sorted, col] = ins_keys_flat[order_bag]

    all_vals = np.concatenate([kept_vals, ins_vals], axis=1)
    all_keys = np.concatenate([kept_keys, ins_keys], axis=1)
    final = np.argsort(all_keys, axis=1, kind="stable")[:, :out_len]
    out_vals = np.take_along_axis(all_vals, final, axis=1)
    out_keys = np.take_along_axis(all_keys, final, axis=1)
    out_lens = np.minimum(kept_n + row_counts, out_len).astype(np.int32)
    out = np.where(out_keys < np.inf, out_vals, pad_id).astype(np.int32)
    if out.shape[1] < out_len:
        out = np.pad(out, ((0, 0), (0, out_len - out.shape[1])),
                     constant_values=pad_id)
    return out, out_lens


def rand_perm_arrays(
    ids: np.ndarray, lens: np.ndarray, p: float, rng: np.random.Generator,
) -> np.ndarray:
    """The JAX package's vectorised ``rand_perm``: shuffle ~``p`` of all valid
    tokens across the batch, in place of their slots (lengths unchanged)."""
    B, L = ids.shape
    valid = np.arange(L)[None, :] < lens[:, None]
    sel = (rng.uniform(size=(B, L)) < p) & valid
    out = ids.copy()
    chosen = out[sel]
    out[sel] = chosen[rng.permutation(len(chosen))]
    return out


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
