"""Word2Vec (CBOW + negative sampling, gensim-default hyperparameters) and
Word-Mover's-Distance: the port's copy of the JAX package's
``text/word2vec.py`` (the reference's gensim dependency, ``src/wmd.py``).

The numpy trainer is the JAX package's own, line for line, so with the same
seed it gives the same vectors; the ``.npz`` format (``vectors`` plus a json
``meta`` of vocab and dim) is the same, so either package loads the other's
file. WMD here is the exact optimal-transport solution (gensim's
pyemd-backed ``wmdistance``); the training labels use the batched Sinkhorn
(``data/wmd_labels.py``). ``train_token_w2v`` and ``train_sentences_w2v``
train with the hogwild C++ trainer of ``text/native.py`` (the same vocab
building and CBOW/negative-sampling scheme, multithreaded), as the JAX
package's do when its library is built; ``prefer_native=False`` takes the
numpy trainer. A failed native build raises: nothing falls back.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

from ..ops.emd import exact_ot_cost
from .native import native_w2v_train


class Word2Vec:
    """CBOW negative-sampling word vectors with gensim-like defaults
    (dim=100, window=5, min_count=5, negative=5, sample=1e-3)."""

    def __init__(
        self,
        sentences: Sequence[Sequence[str]] | None = None,
        dim: int = 100,
        window: int = 5,
        min_count: int = 5,
        negative: int = 5,
        epochs: int = 5,
        lr: float = 0.025,
        min_lr: float = 1e-4,
        sample: float = 1e-3,
        seed: int = 1,
    ):
        self.dim = dim
        self.window = window
        self.min_count = min_count
        self.negative = negative
        self.epochs = epochs
        self.lr = lr
        self.min_lr = min_lr
        self.sample = sample
        self.seed = seed
        self.vocab: dict[str, int] = {}
        self.vectors: np.ndarray | None = None   # input vectors (the embeddings)
        self._norm_vectors: np.ndarray | None = None
        if sentences is not None:
            self._train(sentences)

    # ------------------------------------------------------------------ train
    def _build_vocab(self, sentences: Sequence[Sequence[str]]) -> np.ndarray:
        counts = Counter(tok for sent in sentences for tok in sent)
        items = [(w, c) for w, c in counts.items() if c >= self.min_count]
        items.sort(key=lambda wc: (-wc[1], wc[0]))
        self.vocab = {w: i for i, (w, _) in enumerate(items)}
        return np.array([c for _, c in items], dtype=np.float64)

    def _train(self, sentences: Sequence[Sequence[str]]) -> None:
        rng = np.random.default_rng(self.seed)
        counts = self._build_vocab(sentences)
        V = len(self.vocab)
        if V == 0:
            self.vectors = np.zeros((0, self.dim), dtype=np.float32)
            return

        # Unigram^0.75 negative-sampling table.
        noise = counts ** 0.75
        noise /= noise.sum()

        # Subsampling keep-probabilities (gensim formula).
        total = counts.sum()
        freq = counts / total
        keep = np.minimum(1.0, (np.sqrt(freq / self.sample) + 1) * (self.sample / freq))

        W = (rng.random((V, self.dim), dtype=np.float32) - 0.5) / self.dim
        C = np.zeros((V, self.dim), dtype=np.float32)

        encoded = [
            np.array([self.vocab[t] for t in sent if t in self.vocab], dtype=np.int64)
            for sent in sentences
        ]
        encoded = [e for e in encoded if len(e) > 0]

        n_steps = max(1, sum(len(e) for e in encoded) * self.epochs)
        step = 0
        for _epoch in range(self.epochs):
            for sent in encoded:
                if self.sample > 0:
                    mask = rng.random(len(sent)) < keep[sent]
                    sent = sent[mask]
                n = len(sent)
                for pos in range(n):
                    lr = max(self.min_lr, self.lr * (1 - step / n_steps))
                    step += 1
                    b = rng.integers(0, self.window)
                    lo, hi = max(0, pos - self.window + b), min(n, pos + self.window - b + 1)
                    ctx = np.concatenate([sent[lo:pos], sent[pos + 1 : hi]])
                    if len(ctx) == 0:
                        continue
                    h = W[ctx].mean(axis=0)
                    targets = np.empty(self.negative + 1, dtype=np.int64)
                    targets[0] = sent[pos]
                    targets[1:] = rng.choice(V, size=self.negative, p=noise)
                    labels = np.zeros(self.negative + 1, dtype=np.float32)
                    labels[0] = 1.0
                    out = C[targets]                      # (K, D)
                    scores = 1.0 / (1.0 + np.exp(-out @ h))
                    g = (labels - scores) * lr            # (K,)
                    grad_h = g @ out                      # (D,)
                    C[targets] += np.outer(g, h)
                    W[ctx] += grad_h / len(ctx)

        self.vectors = W

    # ---------------------------------------------------------------- vectors
    def init_sims(self) -> None:
        """L2-normalize vectors in place (gensim ``init_sims(replace=True)``,
        reference ``src/wmd.py:54``)."""
        if self.vectors is not None and len(self.vectors):
            norms = np.linalg.norm(self.vectors, axis=1, keepdims=True)
            self.vectors = self.vectors / np.maximum(norms, 1e-12)
        self._norm_vectors = self.vectors

    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def __getitem__(self, word: str) -> np.ndarray:
        return self.vectors[self.vocab[word]]

    # -------------------------------------------------------------------- wmd
    def wmdistance(self, doc1: Sequence[str], doc2: Sequence[str]) -> float:
        """Exact Word-Mover's Distance between two token lists, with gensim
        semantics: OOV tokens dropped; returns inf when either side is empty
        after filtering; euclidean ground metric over (normalized) vectors."""
        t1 = [t for t in doc1 if t in self.vocab]
        t2 = [t for t in doc2 if t in self.vocab]
        if not t1 or not t2:
            return float("inf")
        words = sorted(set(t1) | set(t2))
        idx = {w: i for i, w in enumerate(words)}
        p = np.zeros(len(words))
        q = np.zeros(len(words))
        for t in t1:
            p[idx[t]] += 1
        for t in t2:
            q[idx[t]] += 1
        p /= p.sum()
        q /= q.sum()
        vecs = np.stack([self.vectors[self.vocab[w]] for w in words])
        diff = vecs[:, None, :] - vecs[None, :, :]
        D = np.sqrt((diff**2).sum(-1))
        return float(exact_ot_cost(p, q, D))

    def cal_wmd_label(
        self,
        xs1: Sequence[Sequence[int]],
        xs2: Sequence[Sequence[int]],
        tokenizer,
    ) -> list[float]:
        """Per-pair WMD regression labels with the reference's edge-case
        handling (``src/wmd.py:34-45``): empty side -> max(len); inf ->
        mean(len)."""
        labels: list[float] = []
        for x1, x2 in zip(xs1, xs2):
            if len(x1) == 0 or len(x2) == 0:
                labels.append(float(max(len(x1), len(x2))))
                continue
            d = self.wmdistance(tokenizer.ids_to_tokens(x1), tokenizer.ids_to_tokens(x2))
            if d == float("inf"):
                labels.append((len(x1) + len(x2)) / 2)
            else:
                labels.append(d)
        return labels

    # --------------------------------------------------------------------- io
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            vectors=self.vectors,
            meta=np.frombuffer(
                json.dumps(
                    {"vocab": self.vocab, "dim": self.dim}
                ).encode("utf-8"),
                dtype=np.uint8,
            ),
        )

    @classmethod
    def load(cls, path: str) -> "Word2Vec":
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        meta = json.loads(bytes(data["meta"]).decode("utf-8"))
        w2v = cls(None, dim=meta["dim"])
        w2v.vocab = {k: int(v) for k, v in meta["vocab"].items()}
        w2v.vectors = data["vectors"]
        return w2v


def train_token_w2v(files: Iterable[str], tokenizer, epochs: int = 10, seed: int = 1,
                    prefer_native: bool = True, **kw) -> Word2Vec:
    """Train word2vec over BPE-token streams of the train corpora: the
    reference's WMD labeler setup (``src/wmd.py:14-19``: shuffled corpus,
    10 epochs, gensim defaults otherwise), with the native trainer, or the
    numpy one when ``prefer_native`` is false."""
    corpus: list[str] = []
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            corpus += [line.strip() for line in f]
    rng = np.random.default_rng(seed)
    rng.shuffle(corpus)
    sentences = [tokenizer.ids_to_tokens(tokenizer.encode(s)) for s in corpus]
    return train_sentences_w2v(sentences, epochs=epochs, seed=seed,
                               prefer_native=prefer_native, **kw)


def train_sentences_w2v(sentences, epochs: int = 5, seed: int = 1, prefer_native: bool = True,
                        **kw) -> Word2Vec:
    """Train word2vec over pre-tokenized sentences with the native trainer
    (the eval harness's masked word2vec), or the numpy one (a per-token SGD
    loop) when ``prefer_native`` is false."""
    if prefer_native:
        return _native_w2v(sentences, epochs=epochs, seed=seed, **kw)
    return Word2Vec(sentences, epochs=epochs, seed=seed, **kw)


def _native_w2v(sentences, epochs: int, seed: int, dim: int = 100, window: int = 5,
                min_count: int = 5, negative: int = 5, sample: float = 1e-3,
                n_threads: int | None = None) -> Word2Vec:
    """The JAX package's ``text/word2vec.py::_native_w2v``: the numpy
    trainer's vocab (``min_count``, sorted by count then word), the
    sentences as its ids, then ``native_w2v_train`` with the same
    defaults (dim 100, window 5, negative 5, ``min(cpu_count, 8)``
    threads)."""
    w2v = Word2Vec(None, dim=dim, window=window, min_count=min_count, negative=negative,
                   epochs=epochs, sample=sample, seed=seed)
    w2v._build_vocab(sentences)
    if not w2v.vocab:
        w2v.vectors = np.zeros((0, dim), np.float32)
        return w2v
    encoded = [[w2v.vocab[t] for t in sent if t in w2v.vocab] for sent in sentences]
    w2v.vectors = native_w2v_train([e for e in encoded if e], vocab_size=len(w2v.vocab),
                                   dim=dim, window=window, negative=negative, epochs=epochs,
                                   sample=sample, seed=seed, n_threads=n_threads)
    return w2v
