"""Corpus BLEU / self-BLEU / reference-BLEU.

The reference's harness reports only STI/CP/NT, but the style-transfer
literature (and this build's north-star metric) also tracks self-BLEU
(transfer vs source — content retention) and reference-BLEU (transfer vs the
human references shipped in ``data/yelp/reference.{0,1}``). Standard BLEU-4:
clipped n-gram precision, geometric mean, brevity penalty; whitespace
tokenization (the corpora are pre-tokenized).

The port's copy of the JAX package's ``evaluate/bleu.py``, unchanged."""

from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    candidates: Iterable[str],
    references: Iterable[Sequence[str] | str],
    max_n: int = 4,
    smooth: bool = True,
) -> float:
    """BLEU-{max_n} over a corpus. Each candidate may have one or more
    references (a string or a list of strings)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        if isinstance(refs, str):
            refs = [refs]
        c_toks = cand.split()
        r_toks = [r.split() for r in refs]
        cand_len += len(c_toks)
        # closest reference length
        ref_len += min((abs(len(r) - len(c_toks)), len(r)) for r in r_toks)[1]
        for n in range(1, max_n + 1):
            c_ngr = _ngrams(c_toks, n)
            max_ref: Counter = Counter()
            for r in r_toks:
                for g, cnt in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], cnt)
            totals[n - 1] += max(len(c_toks) - n + 1, 0)
            clipped[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in c_ngr.items())
    log_p = 0.0
    for n in range(max_n):
        num, den = clipped[n], totals[n]
        if smooth and num == 0:  # add-1 smoothing above unigrams (Lin&Och)
            num, den = (num + 1, den + 1) if n > 0 else (num, den)
        if num == 0 or den == 0:
            return 0.0
        log_p += math.log(num / den)
    log_p /= max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    return 100.0 * bp * math.exp(log_p)


def self_bleu(transfers: Iterable[str], sources: Iterable[str]) -> float:
    """BLEU of transfers against their own source sentences (content
    retention; higher = more copied content)."""
    return corpus_bleu(transfers, sources)


def reference_bleu(transfers: Iterable[str], references: Iterable[str]) -> float:
    """BLEU of transfers against human-written reference transfers."""
    return corpus_bleu(transfers, references)
