"""CP — content preservation (reference ``evaluate/auto/content_preserve.py``):
mask lexicon words with the literal token ``MASK``, train word2vec on the
masked corpus (gensim defaults), then per-pair WMD between the masked transfer
and the masked original (note the reference swaps the arg order at the call
site, ``evaluate/eval.py:41-43`` — WMD is symmetric so it only affects which
side is 'references'). Lower is better.

The port's copy of the JAX package's ``evaluate/content.py``. The word2vec
trains with the native hogwild trainer, as the JAX package's does when its
library is built (``prefer_native=False``: the numpy trainer), for the same
5 epochs; WMD is the exact LP per pair (``Word2Vec.wmdistance``)."""

from __future__ import annotations

from ..text.word2vec import Word2Vec, train_sentences_w2v
from .retokenize import tokenize

MASK_TOKEN = "MASK"


def mask_style_words(texts, lexicon) -> list[str]:
    out = []
    for text in texts:
        toks = [MASK_TOKEN if t.lower() in lexicon else t for t in tokenize(text)]
        out.append(" ".join(toks))
    return out


def train_masked_word2vec(texts, path: str, seed: int = 1, prefer_native: bool = True,
                          **kw) -> Word2Vec:
    """``kw`` goes to the trainer (``n_threads`` to the native one)."""
    sentences = [tokenize(t) for t in texts]
    w2v = train_sentences_w2v(sentences, epochs=5, seed=seed,  # gensim defaults
                              prefer_native=prefer_native, **kw)
    w2v.save(path)
    return w2v


def load_masked_word2vec(path: str) -> Word2Vec:
    w2v = Word2Vec.load(path)
    w2v.init_sims()  # normalize, content_preserve.py:39
    return w2v


def calculate_wmd_scores(references, candidates, w2v) -> list[float]:
    return [
        w2v.wmdistance(tokenize(r), tokenize(c))
        for r, c in zip(references, candidates)
    ]
