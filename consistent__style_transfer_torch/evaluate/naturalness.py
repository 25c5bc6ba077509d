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

import numpy as np

from .lexicon import l1_logistic_regression, load_model


def train_adversarial_lr(tsf_sentences, ori_sentences, vectorizer,
                         limit: int = 200_000, seed: int = 0):
    """Reference parity: ``nt_classifier.py:17-25`` trains through
    ``load_train_set`` which shuffles and caps each class at 200k sentences
    (``evaluate/auto/utils.py:35-45``) — at the reference's 540k-lines/style
    scale the cap is what keeps the L1-LR fit tractable."""
    rng = np.random.default_rng(seed)
    tsf = list(tsf_sentences)
    ori = list(ori_sentences)
    if len(tsf) > limit:
        tsf = [tsf[i] for i in rng.permutation(len(tsf))[:limit]]
    if len(ori) > limit:
        ori = [ori[i] for i in rng.permutation(len(ori))[:limit]]
    x = tsf + ori
    y = np.concatenate([np.zeros(len(tsf)), np.ones(len(ori))])
    lr = l1_logistic_regression(C=3, seed=seed)
    lr.fit(vectorizer.transform(x), y)
    return lr


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
