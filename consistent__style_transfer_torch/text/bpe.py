"""Character-level BPE tokenizer with an HF ``CharBPETokenizer``-compatible
on-disk format (``<ds>-vocab.json`` + ``<ds>-merges.txt``).

The port's own copy of the JAX package's pure-Python tokenizer
(``consistent__style_transfer_tpu/text/bpe.py``): the same training rule,
encode/decode and file format, so either package reads the other's dump and
both give the same ids. Special ids are fixed: PAD=0, BOS=1, EOS=2,
``<unk>``=3 (reference ``src/vocab.py:9-19``). :func:`train_tokenizer` is
the vocab-training entry: the C++ trainer of ``text/native.py`` (the same
tables) unless asked for the Python one.
"""

from __future__ import annotations

import json
import os
import unicodedata
from collections import Counter
from typing import Iterable, Sequence

from .. import BOS, EOS, PAD, SPECIAL_TOKENS, UNK
from .native import native_bpe_train

SUFFIX = "</w>"
_MERGES_HEADER = "#version: 0.2 - Trained by `consistent__style_transfer_torch`"


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def pre_tokenize(text: str) -> list[str]:
    """Whitespace split with punctuation isolated into single-char words."""
    words: list[str] = []
    buf: list[str] = []
    for ch in text:
        if ch.isspace():
            if buf:
                words.append("".join(buf))
                buf = []
        elif _is_punct(ch):
            if buf:
                words.append("".join(buf))
                buf = []
            words.append(ch)
        else:
            buf.append(ch)
    if buf:
        words.append("".join(buf))
    return words


def word_to_symbols(word: str) -> tuple[str, ...]:
    """A word becomes its chars, with the end-of-word suffix on the last one."""
    if not word:
        return ()
    chars = list(word)
    chars[-1] = chars[-1] + SUFFIX
    return tuple(chars)


class BPETokenizer:
    """Char-level BPE with end-of-word suffix ``</w>``.

    ``vocab`` maps token string -> id; ``merges`` is the learned merge list in
    priority order (earlier = applied first).
    """

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.merges = list(merges)
        self.merge_ranks = {pair: i for i, pair in enumerate(self.merges)}
        self.unk_id = self.vocab.get(UNK, 3)
        self._cache: dict[str, list[int]] = {}

    # ------------------------------------------------------------------ train
    @classmethod
    def train(
        cls,
        files: Iterable[str],
        vocab_size: int,
        special_tokens: Sequence[str] = SPECIAL_TOKENS,
        min_frequency: int = 0,
    ) -> "BPETokenizer":
        word_freq: Counter[str] = Counter()
        for path in files:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    word_freq.update(pre_tokenize(line.strip()))

        # Corpus words as mutable symbol sequences.
        words = [(list(word_to_symbols(w)), c) for w, c in word_freq.items() if w]

        vocab: dict[str, int] = {}
        for tok in special_tokens:
            vocab[tok] = len(vocab)
        alphabet = sorted({s for syms, _ in words for s in syms})
        for s in alphabet:
            if s not in vocab:
                vocab[s] = len(vocab)

        merges: list[tuple[str, str]] = []
        pair_freq: Counter[tuple[str, str]] = Counter()
        for syms, c in words:
            for a, b in zip(syms, syms[1:]):
                pair_freq[(a, b)] += c

        while len(vocab) < vocab_size and pair_freq:
            # Deterministic argmax: highest count, ties broken lexicographically.
            best, best_c = None, -1
            for pair, c in pair_freq.items():
                if c > best_c or (c == best_c and best is not None and pair < best):
                    best, best_c = pair, c
            if best is None or best_c < max(min_frequency, 1):
                break
            new_sym = best[0] + best[1]
            merges.append(best)
            vocab[new_sym] = len(vocab)
            # Apply the merge in place, updating pair counts incrementally.
            for syms, c in words:
                i = 0
                while i < len(syms) - 1:
                    if syms[i] == best[0] and syms[i + 1] == best[1]:
                        left = syms[i - 1] if i > 0 else None
                        right = syms[i + 2] if i + 2 < len(syms) else None
                        if left is not None:
                            pair_freq[(left, best[0])] -= c
                            pair_freq[(left, new_sym)] += c
                        if right is not None:
                            pair_freq[(best[1], right)] -= c
                            pair_freq[(new_sym, right)] += c
                        syms[i : i + 2] = [new_sym]
                    else:
                        i += 1
            del pair_freq[best]
            pair_freq = +pair_freq  # drop non-positive entries

        return cls(vocab, merges)

    # ----------------------------------------------------------------- encode
    def _bpe_word(self, word: str) -> list[str]:
        syms = list(word_to_symbols(word))
        if len(syms) == 1:
            return syms
        while len(syms) > 1:
            ranked = [
                (self.merge_ranks.get((a, b)), i)
                for i, (a, b) in enumerate(zip(syms, syms[1:]))
            ]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            syms[i : i + 2] = [syms[i] + syms[i + 1]]
        return syms

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in pre_tokenize(text):
            cached = self._cache.get(word)
            if cached is None:
                cached = [self.vocab.get(s, self.unk_id) for s in self._bpe_word(word)]
                self._cache[word] = cached
            ids.extend(cached)
        return ids

    def ids_to_tokens(self, ids: Sequence[int]) -> list[str]:
        return [self.inv_vocab.get(int(i), UNK) for i in ids]

    # ----------------------------------------------------------------- decode
    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        special = set(SPECIAL_TOKENS) if skip_special else {PAD}
        parts: list[str] = []
        for i in ids:
            tok = self.inv_vocab.get(int(i))
            if tok is None or tok in special:
                continue
            parts.append(tok)
        text = "".join(parts).replace(SUFFIX, " ")
        return text.strip()

    # --------------------------------------------------------------------- io
    def save(self, path: str, name: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"{name}-vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(os.path.join(path, f"{name}-merges.txt"), "w", encoding="utf-8") as f:
            f.write(_MERGES_HEADER + "\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")

    @classmethod
    def load(cls, vocab_path: str, merges_path: str) -> "BPETokenizer":
        with open(vocab_path, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        tok = cls(vocab, merges)
        # Guarantee the framework's fixed special ids (reference src/vocab.py:9-11).
        for t, want in zip(SPECIAL_TOKENS, range(4)):
            if tok.vocab.get(t, want) != want and t in (PAD, BOS, EOS):
                raise ValueError(f"special token {t!r} has id {tok.vocab[t]}, expected {want}")
        return tok

    def __len__(self) -> int:
        return len(self.vocab)


def train_tokenizer(files: Sequence[str], vocab_size: int,
                    prefer_native: bool = True) -> BPETokenizer:
    """Train the vocab and merge tables on ``files``, as the JAX package's
    ``text/bpe.py:244-262`` does: with the C++ trainer (``native_bpe_train``,
    whose tables equal :meth:`BPETokenizer.train`'s), or with the Python
    trainer when ``prefer_native`` is false. A failed native build raises."""
    if not prefer_native:
        return BPETokenizer.train(files, vocab_size)
    return BPETokenizer(*native_bpe_train(files, vocab_size))
