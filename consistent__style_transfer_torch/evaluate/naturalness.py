"""NT — naturalness (reference ``evaluate/auto/naturalness.py`` +
``nt_classifier.py``): an adversarial L1-LR unigram classifier is trained to
separate a system's *transferred* train sentences (label 0) from *original*
train sentences (label 1); at eval time each (original, transfer) pair yields
a relative judgment — 1 if the original scored strictly more natural, 0 if
less, None on ties — and NT is the fraction of pairs judged None or 0 (the
transfer looked at least as natural as the original). Higher is better.

The port's copy of the JAX package's ``evaluate/naturalness.py``; the LR is
the port's :class:`~.lexicon.L1LogisticRegression`, saved as ``.npz``."""

from __future__ import annotations

import time

import numpy as np

from .lexicon import l1_logistic_regression, load_model


def adversarial_train_set(tsf_sentences, ori_sentences, limit: int = 200_000,
                          seed: int = 0):
    """(texts, labels): the transferred sentences (label 0) then the
    originals (label 1). Reference parity: ``nt_classifier.py:17-25`` trains
    through ``load_train_set`` which shuffles and caps each class at 200k
    sentences (``evaluate/auto/utils.py:35-45``) — at the reference's
    540k-lines/style scale the cap is what keeps the L1-LR fit tractable."""
    rng = np.random.default_rng(seed)
    tsf = list(tsf_sentences)
    ori = list(ori_sentences)
    if len(tsf) > limit:
        tsf = [tsf[i] for i in rng.permutation(len(tsf))[:limit]]
    if len(ori) > limit:
        ori = [ori[i] for i in rng.permutation(len(ori))[:limit]]
    return tsf + ori, np.concatenate([np.zeros(len(tsf)), np.ones(len(ori))])


def train_adversarial_lr(tsf_sentences, ori_sentences, vectorizer,
                         limit: int = 200_000, seed: int = 0, prefer_native: bool = True):
    """The L1 LR on :func:`adversarial_train_set`'s sentences through
    ``vectorizer``; ``prefer_native``: its solver (false: Python). Returns
    (the LR, its parts: the transform's and the fit's seconds, the fit's
    Newton iterations and inner passes, and the matrix's shape)."""
    x, y = adversarial_train_set(tsf_sentences, ori_sentences, limit, seed)
    t0 = time.perf_counter()
    X = vectorizer.transform(x)
    t1 = time.perf_counter()
    lr = l1_logistic_regression(C=3, seed=seed, prefer_native=prefer_native).fit(X, y)
    parts = {"solver": "native" if prefer_native else "python", "transform_s": t1 - t0,
             "fit_s": time.perf_counter() - t1, "newton_iter": lr.n_iter_,
             "inner_iter": lr.n_inner_iter_, "rows": X.shape[0], "features": X.shape[1]}
    return lr, parts


class UnigramNaturalnessClassifier:
    """score(texts) -> P(natural) per text (probability column 1,
    reference ``naturalness.py:49-53``)."""

    def __init__(self, model_or_path, vectorizer):
        self.classifier = (
            load_model(model_or_path) if isinstance(model_or_path, str) else model_or_path
        )
        self.vectorizer = vectorizer

    def score(self, texts):
        return self.classifier.predict_proba(self.vectorizer.transform(texts))[:, 1]


def generate_judgments(input_scores, output_scores) -> list[int | None]:
    judgments: list[int | None] = []
    for i_s, o_s in zip(input_scores, output_scores):
        judgments.append(None if i_s == o_s else int(i_s > o_s))
    return judgments


def aggregate_judgments(judgments) -> float:
    success = sum(1 for j in judgments if j is None or j == 0)
    return success / len(judgments)
