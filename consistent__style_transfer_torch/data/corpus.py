"""Corpus loading: eager BPE-encode of style files into fixed-shape arrays.

Same dataset contract as the JAX package (``data/corpus.py``) and the
reference (``src/loader.py:10-40``): one sentence per line; the style label
is the filename suffix (``style.train.0`` -> 0); sentences are BPE-encoded
and truncated to ``max_len`` at load time; empty lines are dropped. The
corpus is one padded ``(N, max_len)`` int32 array + per-row lengths.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _read_lines(path: str) -> tuple[list[str], int]:
    """Non-empty lines + the label parsed from the filename suffix."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    label = int(path.split(".")[-1])
    with open(path, "r", encoding="utf-8") as f:
        lines = [line.strip() for line in f]
    return [l for l in lines if l], label


def load_s2l(path: str, encode_fn) -> list[tuple[list[int], int]]:
    """Ragged (encoded sentence, label) pairs of one style file."""
    lines, label = _read_lines(path)
    return [(encode_fn(s), label) for s in lines]


@dataclass
class StyleCorpus:
    """All sentences of one split as fixed-shape arrays."""

    ids: np.ndarray      # (N, max_len) int32, right-padded with PAD
    lengths: np.ndarray  # (N,) int32 true lengths (<= max_len)
    labels: np.ndarray   # (N,) int32

    @classmethod
    def from_files(cls, files, tokenizer, max_len: int) -> "StyleCorpus":
        id_blocks, len_blocks, label_blocks = [], [], []
        for path in files:
            lines, label = _read_lines(path)
            ids = np.zeros((len(lines), max_len), dtype=np.int32)
            lens = np.zeros(len(lines), dtype=np.int32)
            for i, line in enumerate(lines):
                enc = tokenizer.encode(line)[:max_len]
                ids[i, : len(enc)] = enc
                lens[i] = len(enc)
            id_blocks.append(ids)
            len_blocks.append(lens)
            label_blocks.append(np.full(len(lines), label, dtype=np.int32))
        return cls(
            np.concatenate(id_blocks, axis=0),
            np.concatenate(len_blocks, axis=0),
            np.concatenate(label_blocks, axis=0),
        )

    def __len__(self) -> int:
        return len(self.labels)
