"""Batch pipeline: ragged host data -> fixed-shape numpy batches.

The port's copy of the JAX package's ``data/pipeline.py`` for the optimize
layout (x, labels), which is what inference reads. Every batch has the same
shape (B, max_len); the last partial batch is padded up to B by repeating
index 0 at the END, with a ``valid`` count so inference discards the padding
on the host. The warmup and pretrain collates come with their slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from .corpus import StyleCorpus


@dataclass
class Batch:
    arrays: dict[str, np.ndarray]
    valid: int  # number of non-padding rows

    def __getitem__(self, k: str) -> np.ndarray:
        return self.arrays[k]


def _batch_indices(n: int, batch_size: int, shuffle: bool, drop_last: bool,
                   rng: np.random.Generator) -> list[tuple[np.ndarray, int]]:
    """(indices, n_real) per batch; the last partial batch is padded at the
    END by repeating index 0, with n_real recording how many leading rows are
    genuine (a pad index of 0 is indistinguishable from a real 0, so the count
    must be tracked here, not re-derived from the indices)."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    out = []
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        n_real = len(idx)
        if n_real < batch_size:
            if drop_last:
                break
            pad = np.zeros(batch_size - n_real, dtype=idx.dtype)
            idx = np.concatenate([idx, pad])
        out.append((idx, n_real))
    return out


class BatchIterator:
    """Re-iterable epoch iterator; each epoch reshuffles deterministically."""

    def __init__(
        self,
        corpus: StyleCorpus,
        batch_size: int,
        max_len: int,
        collate: Callable[[np.ndarray, np.ndarray, np.ndarray, np.random.Generator], dict],
        shuffle: bool = True,
        drop_last: bool | None = None,
        seed: int = 0,
    ):
        self.corpus = corpus
        self.batch_size = batch_size
        self.max_len = max_len
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.epoch = 0

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, self.epoch))
        n = len(self.corpus)
        for idx, valid in _batch_indices(n, self.batch_size, self.shuffle,
                                         self.drop_last, rng):
            ids = self.corpus.ids[idx]
            lens = self.corpus.lengths[idx]
            labels = self.corpus.labels[idx]
            yield Batch(self.collate(ids, lens, labels, rng), valid=valid)
        self.epoch += 1

    def __len__(self) -> int:
        n = len(self.corpus)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


def collate_optimize(max_len: int):
    def fn(ids, lens, labels, rng):
        return {"x": ids, "labels": labels.astype(np.int32), "lengths": lens}
    return fn


def make_batches(corpus: StyleCorpus, batch_size: int, max_len: int, stage: str,
                 shuffle: bool, seed: int = 0) -> BatchIterator:
    if stage != "optimize":
        raise NotImplementedError(
            f"stage {stage!r} batches come with a later slice of the port (ROADMAP.md)")
    return BatchIterator(corpus, batch_size, max_len, collate_optimize(max_len),
                         shuffle=shuffle, seed=seed)
