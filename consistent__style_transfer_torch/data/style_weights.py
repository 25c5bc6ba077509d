"""Per-token style-neutrality weights for the masked copy regularizer
(``Config.w_copy`` with ``Config.copy_mask``): the port of the JAX package's
``data/style_weights.py``.

The weight of token t is ``1 - |2 q_t - 1|`` with ``q_t = P(style=1 | t)``
under add-alpha smoothing: 1.0 for a token both styles use alike, towards 0
for a token only one style uses, so the copy loss leaves style words to the
style loss. Corpus statistics only, on the host; no reference equivalent.

    python -m consistent__style_transfer_torch.data.style_weights yelp [key=value ...]

prints :func:`mask_stats` of a dataset's training split.
"""

from __future__ import annotations

import numpy as np

from .corpus import StyleCorpus


def style_neutrality_weights(corpus: StyleCorpus, n_vocab: int,
                             alpha: float = 1.0) -> np.ndarray:
    """(n_vocab,) float32 in [0, 1]; specials (PAD/BOS/EOS) and unseen tokens
    get weight 1.0 (fully neutral)."""
    valid = np.arange(corpus.ids.shape[1])[None, :] < corpus.lengths[:, None]
    counts = np.zeros((2, n_vocab), dtype=np.float64)
    for s in (0, 1):
        rows = corpus.labels == s
        counts[s] = np.bincount(corpus.ids[rows][valid[rows]], minlength=n_vocab)[:n_vocab]
    total = counts[0] + counts[1]
    q = (counts[1] + alpha) / (total + 2.0 * alpha)
    w = 1.0 - np.abs(2.0 * q - 1.0)
    w[total == 0] = 1.0
    w[:3] = 1.0  # PAD/BOS/EOS carry no style
    return w.astype(np.float32)


def mask_stats(corpus: StyleCorpus, weights: np.ndarray) -> dict:
    """How much style exemption the mask gives a corpus: the token-frequency
    weighted mean neutrality (a flat mask, near 1, makes the masked copy loss
    a uniform one) and the share of tokens weighted below 0.5."""
    valid = np.arange(corpus.ids.shape[1])[None, :] < corpus.lengths[:, None]
    counts = np.bincount(corpus.ids[valid], minlength=len(weights))[: len(weights)]
    counts = counts.astype(np.float64)
    total = counts.sum()
    return {
        "freq_weighted_mean_neutrality": float((weights * counts).sum() / total),
        "token_fraction_below_half": float(counts[weights < 0.5].sum() / total),
    }


def main(argv=None) -> None:
    import json
    import sys

    from ..config import config_from_args
    from ..train.common import get_corpus, get_tokenizer

    argv = list(sys.argv[1:] if argv is None else argv)
    dataset = argv[0] if argv else "yelp"
    flags = [f"--{kv.split('=', 1)[0]}={kv.split('=', 1)[1]}" for kv in argv[1:]]
    cfg = config_from_args(["--dataset", dataset, *flags])
    tok = get_tokenizer(cfg)
    corpus = get_corpus(cfg, "train", tok)
    print(json.dumps(mask_stats(corpus, style_neutrality_weights(corpus, len(tok)))))


if __name__ == "__main__":
    main()
