"""Batch pipeline: ragged host data -> fixed-shape numpy batches.

The port's copy of the JAX package's ``data/pipeline.py``. Every batch has
the same shape (B, max_len); the last partial batch is padded up to B by
repeating index 0 at the END, with a ``valid`` count so evaluation and
inference discard the padding; training iterators drop it instead.

Stage batch layouts (the reference's collates, ``src/loader.py:46-90``):
- optimize: (x, labels), which is what inference reads;
- warmup: (noised x, x, labels), one transfer_noise(p=0.1) draw aligned to
  max_len;
- pretrain: (x, noise1, noise2, perm-noise, labels, wmd) with two independent
  transfer_noise(p=0.15) draws, one rand_perm(0.15) and the WMD label between
  the two noised variants.

Under data parallelism every rank builds the global batch, with the same
host noise draws in the same order, and keeps its rows
(``parallel/sharding.py``), so a rank's rows equal the same rows of a
one-process batch bit for bit. The optimize and warmup batches are split on
their way to the device (``data/prefetch.py``); the pretrain collate splits
before its WMD labels, so each rank labels only its own pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from .. import PAD_ID
from .corpus import StyleCorpus
from .noise import rand_perm_arrays, transfer_noise_arrays


@dataclass
class Batch:
    arrays: dict[str, np.ndarray]
    valid: int  # number of non-padding rows of the global batch
    start: int = 0  # the global row of arrays' first row (a rank's rows)

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
        start: int = 0,
    ):
        self.corpus = corpus
        self.batch_size = batch_size
        self.max_len = max_len
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.start = start  # see Batch.start: a collate that keeps a rank's rows
        self.epoch = 0

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, self.epoch))
        n = len(self.corpus)
        for idx, valid in _batch_indices(n, self.batch_size, self.shuffle,
                                         self.drop_last, rng):
            ids = self.corpus.ids[idx]
            lens = self.corpus.lengths[idx]
            labels = self.corpus.labels[idx]
            yield Batch(self.collate(ids, lens, labels, rng), valid=valid, start=self.start)
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


def collate_warmup(max_len: int, p: float = 0.1):
    def fn(ids, lens, labels, rng):
        nx, nlen = transfer_noise_arrays(ids, lens, p=p, rng=rng, out_len=max_len, pad_id=PAD_ID)
        return {"nx": nx, "x": ids, "labels": labels.astype(np.int32), "lengths": lens,
                "nlengths": nlen}
    return fn


def collate_pretrain(max_len: int, wmd_labeler, p: float = 0.15, need_matcher=None,
                     rows: slice | None = None):
    """``wmd_labeler.label_pairs(ids1, lens1, ids2, lens2)`` gives the (B,)
    float32 labels: a tensor on the labeler's device (Sinkhorn), which stays
    there, or a numpy array (exact host OT). Noised rows can exceed max_len
    (insertions), so like the reference they keep their own width
    ``noise_len = max_len + max(4, max_len // 2)``.

    ``need_matcher`` (nullary callable, default always true) gates the
    matcher-only work: once pretrain freezes the matcher, the two
    transfer_noise variants and the WMD label are not computed, and zeros of
    the same shape take their place. The two skipped draws then no longer
    consume the host generator, so later rand_perm noise differs from an
    ungated run at the same seed, as in the JAX package.

    ``rows`` (a data-parallel rank's slice of the batch): every draw is made
    for the global batch, then only these rows are kept and labelled."""
    noise_len = max_len + max(4, max_len // 2)
    keep = slice(None) if rows is None else rows

    def fn(ids, lens, labels, rng):
        if need_matcher is None or need_matcher():
            nx1, nl1 = transfer_noise_arrays(ids, lens, p=p, rng=rng,
                                             out_len=noise_len, pad_id=PAD_ID)
            nx2, nl2 = transfer_noise_arrays(ids, lens, p=p, rng=rng,
                                             out_len=noise_len, pad_id=PAD_ID)
            nx1, nl1, nx2, nl2 = nx1[keep], nl1[keep], nx2[keep], nl2[keep]
            wmd = wmd_labeler.label_pairs(nx1, nl1, nx2, nl2)
        else:
            B = len(ids[keep])
            # two arrays, not one aliased twice: an in-place consumer of
            # one must not change the other
            nx1 = np.zeros((B, noise_len), dtype=ids.dtype)
            nx2 = np.zeros((B, noise_len), dtype=ids.dtype)
            wmd = np.zeros(B, np.float32)
        nx3 = rand_perm_arrays(ids, lens, p=p, rng=rng)[keep]
        return {
            "x": ids[keep], "nx1": nx1, "nx2": nx2, "nx3": nx3,
            "labels": labels[keep].astype(np.int32), "wmd": wmd, "lengths": lens[keep],
        }
    return fn


class MegaBatches:
    """Group a :class:`BatchIterator` into stacked (k, B, ...) super-batches
    (the JAX package's ``data/pipeline.py::MegaBatches``), for the optimize
    stage's ``megastep_k``: one host-to-device copy brings k training
    batches. The per-batch content and order are untouched; a last partial
    group (n_batches % k) comes at its true size."""

    def __init__(self, iterator, k: int):
        if k < 1:
            raise ValueError(f"k must be at least 1, got {k}")
        self.iterator = iterator
        self.k = k

    def __iter__(self) -> Iterator[Batch]:
        buf: list[Batch] = []

        def flush():
            arrays = {key: np.stack([b.arrays[key] for b in buf]) for key in buf[0].arrays}
            return Batch(arrays, valid=sum(b.valid for b in buf))

        for batch in self.iterator:
            buf.append(batch)
            if len(buf) == self.k:
                yield flush()
                buf = []
        if buf:
            yield flush()

    def __len__(self) -> int:
        return -(-len(self.iterator) // self.k)


def eval_arrays(batch: Batch) -> dict:
    """Batch arrays + a (B,) float32 ``row_mask`` marking the real rows (the
    first ``batch.valid`` of the global batch, whose row ``batch.start`` is
    the arrays' first), so val means leave out the padded duplicates."""
    arrays = dict(batch.arrays)
    B = len(arrays["labels"])
    arrays["row_mask"] = (batch.start + np.arange(B) < batch.valid).astype(np.float32)
    return arrays


def make_batches(corpus: StyleCorpus, batch_size: int, max_len: int, stage: str,
                 shuffle: bool, seed: int = 0, wmd_labeler=None,
                 need_matcher=None, rows: slice | None = None) -> BatchIterator:
    """The stage's batch iterator. ``rows`` (pretrain only): the rows of
    each global batch a data-parallel rank keeps, before its WMD labels;
    the other stages split their batches on the way to the device."""
    if stage == "optimize":
        collate = collate_optimize(max_len)
    elif stage == "warmup":
        collate = collate_warmup(max_len)
    elif stage == "pretrain":
        if wmd_labeler is None:
            raise ValueError("pretrain batches need a wmd_labeler")
        collate = collate_pretrain(max_len, wmd_labeler, need_matcher=need_matcher, rows=rows)
    else:
        raise ValueError(f"unknown stage {stage!r}")
    if rows is not None and stage != "pretrain":
        raise ValueError("only the pretrain collate keeps a rank's rows")
    return BatchIterator(corpus, batch_size, max_len, collate, shuffle=shuffle, seed=seed,
                         start=0 if rows is None else rows.start)
