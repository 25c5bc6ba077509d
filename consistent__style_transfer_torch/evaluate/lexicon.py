"""Style lexicon: L1 logistic regression over binary unigram counts; the
lexicon is every feature whose weight is more than 2 standard deviations from
the mean of the nonzero weights (reference ``evaluate/auto/style_lexicon.py``:
vectorizer ``:14-17``, LR l1/C=3 ``:81-86``, selection ``:37-43``, JSON layout
under the key "binary sentiment" ``:91-95``).

The port's copy of the JAX package's ``evaluate/lexicon.py``, which fits
scikit-learn's ``CountVectorizer(binary=True)`` and liblinear's L1 logistic
regression. The port carries its own of both:

- :class:`BinaryUnigramVectorizer` has CountVectorizer's semantics as the
  JAX package uses them: lowercase, then :func:`~.retokenize.tokenize`; the
  vocabulary is the sorted set of tokens (a column is a token's rank); 0/1
  entries; unseen tokens dropped; ``transform`` gives a ``scipy.sparse`` CSR
  matrix.
- :class:`L1LogisticRegression` minimises ``||w||_1 + |b| + C * sum_i
  log(1 + exp(-s_i (x_i . w + b)))``, s_i = +-1, the bias a feature of value
  1 regularised like the rest (liblinear's ``intercept_scaling=1``), in
  float64 on the host, with the solver liblinear runs for this problem:
  newGLMNET (Yuan, Ho & Lin, JMLR 2012; liblinear's ``solve_l1r_lr``). The
  fit runs the port's C++ copy of it (``csrc/l1r_lr.cc`` through
  :mod:`.l1r_native`, built with ``g++`` at first use; a failed build
  raises); ``prefer_native=False`` runs :func:`_solve_l1r_lr`, the same
  algorithm in Python, which the tests hold the C++ solver against.

The problem is degenerate: liblinear's own fits under two global numpy
seeds (its coordinate order) differ in single weights by up to 3.9 at
objectives within 1e-5 of each other, and the port's two solvers draw their
coordinate orders from different generators. So the port is held to
liblinear on function (the objective it reaches, the lexicon it selects),
not weight for weight.

Artifacts: the vectorizer is JSON (its vocabulary), the LR ``.npz`` (coef,
intercept, classes); neither is a pickle.
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy import sparse
from scipy.special import expit

from . import l1r_native
from .retokenize import tokenize

STYLE_KEY = "binary sentiment"
TRAIN_CAP = 200_000  # load_train_set cap, evaluate/auto/utils.py:35-45
# scikit-learn's LogisticRegression defaults, which liblinear runs with
TOL, MAX_NEWTON_ITER = 1e-4, 100


class BinaryUnigramVectorizer:
    """``CountVectorizer(binary=True, tokenizer=tokenize)``: ``fit`` learns
    ``vocabulary_`` (token -> column, columns in sorted token order),
    ``transform`` gives an (n_texts, n_vocab) CSR matrix of int64 0/1."""

    def __init__(self, vocabulary: dict[str, int] | None = None):
        self.vocabulary_ = dict(vocabulary or {})

    @staticmethod
    def _tokens(text: str) -> list[str]:
        return tokenize(text.lower())

    def fit(self, texts) -> "BinaryUnigramVectorizer":
        words = set()
        for text in texts:
            words.update(self._tokens(text))
        if not words:
            raise ValueError("empty vocabulary; the texts hold no tokens")
        self.vocabulary_ = {w: i for i, w in enumerate(sorted(words))}
        return self

    def transform(self, texts) -> sparse.csr_matrix:
        vocab = self.vocabulary_
        indptr, indices = [0], []
        for text in texts:
            indices.extend(sorted({vocab[t] for t in self._tokens(text) if t in vocab}))
            indptr.append(len(indices))
        return sparse.csr_matrix(
            (np.ones(len(indices), np.int64), np.asarray(indices, np.int32), np.asarray(indptr)),
            shape=(len(indptr) - 1, len(vocab)))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"vocabulary": self.vocabulary_}, f)

    @classmethod
    def load(cls, path: str) -> "BinaryUnigramVectorizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls({w: int(i) for w, i in json.load(f)["vocabulary"].items()})


def _solve_l1r_lr(X: sparse.csc_matrix, s: np.ndarray, C: float, eps: float,
                  max_newton_iter: int, rng: np.random.Generator) -> tuple[np.ndarray, int, int]:
    """liblinear's ``solve_l1r_lr`` (newGLMNET) on a CSC float64 X whose
    last column is the bias feature; s = +-1. Returns (w, Newton
    iterations, inner passes summed over them). The outer pass over all
    features is vectorised; the coordinate descent on the quadratic model
    runs feature by feature over the active set, in an order drawn from
    ``rng``, with liblinear's shrinking, inner stopping rule and Armijo line
    search."""
    l, n = X.shape
    indptr, indices, data = X.indptr, X.indices, X.data
    XT = X.T.tocsr()
    XT_sq = XT.multiply(XT).tocsr()
    nu, sigma, max_inner, max_linesearch = 1e-12, 0.01, 1000, 20
    neg = s < 0
    xjneg_sum = XT @ (C * neg)

    w = np.zeros(n)
    wpd = np.zeros(n)
    w_norm = 0.0
    exp_wTx = np.ones(l)
    tau = C / (1.0 + exp_wTx)
    D = C * exp_wTx / (1.0 + exp_wTx) ** 2
    inner_eps, Gmax_old, Gnorm1_init = 1.0, np.inf, -1.0
    newton_iter = inner_total = 0
    starts, ends = indptr[:-1].tolist(), indptr[1:].tolist()
    while newton_iter < max_newton_iter:
        # outer pass: gradient, diagonal Hessian, violations, outer shrinking
        Hdiag = nu + XT_sq @ D
        Grad = xjneg_sum - XT @ tau
        Gp, Gn = Grad + 1.0, Grad - 1.0
        zero = w == 0
        viol = np.where(w > 0, np.abs(Gp), np.abs(Gn))
        viol[zero] = np.where(Gp[zero] < 0, -Gp[zero], np.where(Gn[zero] > 0, Gn[zero], 0.0))
        shrink = zero & (Gp >= 0) & (Gn <= 0) & (Gp > Gmax_old / l) & (Gn < -Gmax_old / l)
        active = np.flatnonzero(~shrink)
        Gmax_new, Gnorm1_new = float(viol[active].max(initial=0.0)), float(viol[active].sum())
        if newton_iter == 0:
            Gnorm1_init = Gnorm1_new
        if Gnorm1_new <= eps * Gnorm1_init:
            break

        # coordinate descent on the quadratic model, over the active set
        xTd = np.zeros(l)
        dx = data * D[indices]  # x_ij * D_i, aligned with X.data
        grad_l, hdiag_l, w_l = Grad.tolist(), Hdiag.tolist(), w.tolist()
        wpd_l = wpd.tolist()
        qp_active = active
        QP_Gmax_old = np.inf
        inner = 0
        while inner < max_inner:
            QP_Gmax_new, QP_Gnorm1_new = 0.0, 0.0
            kept = []
            bound = QP_Gmax_old / l
            for j in rng.permutation(qp_active).tolist():
                a, b = starts[j], ends[j]
                rows = indices[a:b]
                G = grad_l[j] + (wpd_l[j] - w_l[j]) * nu + float(dx[a:b] @ xTd[rows])
                H, wj = hdiag_l[j], wpd_l[j]
                gp, gn = G + 1.0, G - 1.0
                if wj == 0:
                    if gp < 0:
                        v = -gp
                    elif gn > 0:
                        v = gn
                    elif gp > bound and gn < -bound:  # inner shrinking
                        continue
                    else:
                        v = 0.0
                elif wj > 0:
                    v = abs(gp)
                else:
                    v = abs(gn)
                kept.append(j)
                QP_Gmax_new = max(QP_Gmax_new, v)
                QP_Gnorm1_new += v
                if gp < H * wj:
                    z = -gp / H
                elif gn > H * wj:
                    z = -gn / H
                else:
                    z = -wj
                if abs(z) < 1e-12:
                    continue
                z = min(max(z, -10.0), 10.0)
                wpd_l[j] = wj + z
                xTd[rows] += z * data[a:b]
            inner += 1
            if QP_Gnorm1_new <= inner_eps * Gnorm1_init:
                if len(kept) == len(active):  # inner stopping
                    break
                qp_active, QP_Gmax_old = active, np.inf  # reactivate the set
                continue
            qp_active = np.asarray(kept, dtype=np.int64)
            QP_Gmax_old = QP_Gmax_new
        inner_total += inner
        wpd = np.asarray(wpd_l)

        # Armijo line search along wpd - w
        delta = float(Grad @ (wpd - w))
        w_norm_new = float(np.abs(wpd).sum())
        delta += w_norm_new - w_norm
        negsum_xTd = float(C * xTd[neg].sum())
        for _ in range(max_linesearch):
            exp_xTd = np.exp(xTd)
            exp_wTx_new = exp_wTx * exp_xTd
            cond = (w_norm_new - w_norm + negsum_xTd - sigma * delta
                    + float(C * np.log((1.0 + exp_wTx_new) / (exp_xTd + exp_wTx_new)).sum()))
            if cond <= 0:
                w_norm, w = w_norm_new, wpd.copy()
                exp_wTx = exp_wTx_new
                tau = C / (1.0 + exp_wTx)
                D = C * exp_wTx / (1.0 + exp_wTx) ** 2
                break
            wpd = (w + wpd) * 0.5
            w_norm_new = float(np.abs(wpd).sum())
            delta *= 0.5
            negsum_xTd *= 0.5
            xTd *= 0.5
        else:  # too many line-search steps: recompute exp(w.x) from w
            exp_wTx = np.exp(X @ w)
        if inner == 1:
            inner_eps *= 0.25
        newton_iter += 1
        Gmax_old = Gmax_new
    return w, newton_iter, inner_total


class L1LogisticRegression:
    """Binary L1-regularised logistic regression with an intercept, fitted
    as liblinear fits ``LogisticRegression(penalty="l1", C=C,
    solver="liblinear")``: the tolerance 1e-4 scaled by liblinear's
    ``min(pos, neg) / l``, at most 100 Newton iterations, the coordinate
    order from ``seed``. ``prefer_native``: the C++ solver (default; its
    order from splitmix64) or, when false, the Python one (its order from
    ``default_rng(seed)``). ``coef_`` (1, n_features), ``intercept_`` (1,)
    and ``classes_`` as scikit-learn names them; the second class is the
    positive one. ``n_iter_`` and ``n_inner_iter_``: the fit's Newton
    iterations and inner passes."""

    def __init__(self, C: float = 3.0, seed: int = 0, prefer_native: bool = True):
        self.C, self.seed, self.prefer_native = C, seed, prefer_native
        self.coef_: np.ndarray | None = None
        self.intercept_: np.ndarray | None = None
        self.classes_: np.ndarray | None = None
        self.n_iter_ = self.n_inner_iter_ = 0

    def fit(self, X, y) -> "L1LogisticRegression":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f"need exactly 2 classes, got {self.classes_.tolist()}")
        s = np.where(y == self.classes_[1], 1.0, -1.0)
        l = X.shape[0]
        Xb = sparse.hstack([sparse.csr_matrix(X, dtype=np.float64),
                            np.ones((l, 1))], format="csc")
        pos = int((s > 0).sum())
        eps = TOL * max(min(pos, l - pos), 1) / l
        if self.prefer_native:
            w, self.n_iter_, self.n_inner_iter_ = l1r_native.solve_l1r_lr(
                Xb, s, float(self.C), eps, MAX_NEWTON_ITER, self.seed)
        else:
            w, self.n_iter_, self.n_inner_iter_ = _solve_l1r_lr(
                Xb, s, float(self.C), eps, MAX_NEWTON_ITER, np.random.default_rng(self.seed))
        self.coef_, self.intercept_ = w[None, :-1], w[-1:].copy()
        return self

    def decision_function(self, X) -> np.ndarray:
        return np.asarray(X @ self.coef_[0]).ravel() + self.intercept_[0]

    def predict_proba(self, X) -> np.ndarray:
        p = expit(self.decision_function(X))
        return np.vstack([1 - p, p]).T

    def objective(self, X, y) -> float:
        """``||w||_1 + |b| + C * sum_i log(1 + exp(-s_i (x_i . w + b)))``."""
        s = np.where(np.asarray(y) == self.classes_[1], 1.0, -1.0)
        margin = s * self.decision_function(X)
        return float(np.abs(self.coef_).sum() + np.abs(self.intercept_).sum()
                     + self.C * np.logaddexp(0.0, -margin).sum())

    def stopping_violation(self, X, y) -> tuple[float, float]:
        """(v, bound): v the sum over the features (the bias too) of
        newGLMNET's optimality violation at the fitted weights (the distance
        of 0 from each coordinate's subdifferential), bound = eps * v at w =
        0, the rule both solvers stop by. Computed from X, y and the weights
        alone; exp(X.w) afresh, where a solver updates it step by step."""
        s = np.where(np.asarray(y) == self.classes_[1], 1.0, -1.0)
        l = X.shape[0]
        Xb = sparse.hstack([sparse.csr_matrix(X, dtype=np.float64), np.ones((l, 1))],
                           format="csr")
        C = float(self.C)

        def violation(w):
            tau = C * expit(-(Xb @ w))  # C / (1 + exp(w.x))
            grad = Xb.T @ (C * (s < 0)) - Xb.T @ tau
            gp, gn = grad + 1.0, grad - 1.0
            at_zero = np.maximum(np.maximum(-gp, gn), 0.0)
            return float(np.where(w > 0, np.abs(gp), np.where(w < 0, np.abs(gn), at_zero)).sum())

        pos = int((s > 0).sum())
        eps = TOL * max(min(pos, l - pos), 1) / l
        w = np.append(self.coef_[0], self.intercept_)
        return violation(w), eps * violation(np.zeros_like(w))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, coef=self.coef_, intercept=self.intercept_, classes=self.classes_)

    @classmethod
    def load(cls, path: str) -> "L1LogisticRegression":
        with np.load(path) as data:
            lr = cls()
            lr.coef_, lr.intercept_, lr.classes_ = data["coef"], data["intercept"], data["classes"]
        return lr


def load_train_set(neg_path: str, pos_path: str, limit: int = TRAIN_CAP, seed: int = 0):
    def load(path):
        with open(path, "r", encoding="utf-8") as f:
            return [line.strip() for line in f]

    rng = np.random.default_rng(seed)
    neg, pos = load(neg_path), load(pos_path)
    rng.shuffle(neg)
    rng.shuffle(pos)
    neg, pos = neg[:limit], pos[:limit]
    x = neg + pos
    y = np.concatenate([np.zeros(len(neg)), np.ones(len(pos))])
    return x, y


def l1_logistic_regression(C: float = 3, seed: int = 0,
                           prefer_native: bool = True) -> L1LogisticRegression:
    return L1LogisticRegression(C=C, seed=seed, prefer_native=prefer_native)


def fit_unigram_lr(x, y, seed: int = 0, prefer_native: bool = True):
    vectorizer = BinaryUnigramVectorizer().fit(x)
    lr = l1_logistic_regression(C=3, seed=seed, prefer_native=prefer_native)
    lr.fit(vectorizer.transform(x), y)
    return lr, vectorizer


def select_lexicon_features(weights: np.ndarray, n_std: float = 2.0) -> np.ndarray:
    std, mean = np.std(weights), np.mean(weights)
    lo, hi = mean - n_std * std, mean + n_std * std
    return np.where((weights < lo) | (weights > hi))[0]


def ranked_lexicon(weights: np.ndarray, vocabulary: dict[str, int]) -> list[tuple[str, float]]:
    """(word, weight) of each selected feature, by weight: the nonzero
    weights outside 2 standard deviations of their mean."""
    inv_vocab = {i: w for w, i in vocabulary.items()}
    nonzero = np.where(np.abs(weights) > 0.0)[0]
    nz_weights = weights[nonzero]
    selected = select_lexicon_features(nz_weights)
    return sorted(((inv_vocab[nonzero[i]], float(nz_weights[i])) for i in selected),
                  key=lambda kv: kv[1])


def generate_lexicon(neg_path: str, pos_path: str, lexicon_path: str,
                     vectorizer_path: str, seed: int = 0, prefer_native: bool = True):
    """Returns (lexicon set, fitted vectorizer); writes both artifacts.
    ``prefer_native``: the LR's solver (false: Python)."""
    x, y = load_train_set(neg_path, pos_path, seed=seed)
    lr, vectorizer = fit_unigram_lr(x, y, seed=seed, prefer_native=prefer_native)
    ranked = ranked_lexicon(lr.coef_[0], vectorizer.vocabulary_)
    payload = {STYLE_KEY: [[w, wt] for w, wt in ranked]}
    os.makedirs(os.path.dirname(lexicon_path) or ".", exist_ok=True)
    with open(lexicon_path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    save_model(vectorizer, vectorizer_path)
    return {w for w, _ in ranked}, vectorizer


def load_lexicon(path: str) -> set[str]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {entry[0] for entry in data[STYLE_KEY]}


def save_model(model, path: str) -> None:
    """The vectorizer as JSON, the LR as ``.npz``."""
    model.save(path)


def load_model(path: str):
    """A vectorizer from a ``.json`` path, an LR from a ``.npz`` path."""
    if path.endswith(".json"):
        return BinaryUnigramVectorizer.load(path)
    if path.endswith(".npz"):
        return L1LogisticRegression.load(path)
    raise ValueError(f"unknown model file type: {path!r} (want .json or .npz)")
