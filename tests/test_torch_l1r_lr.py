"""The port's C++ L1 logistic regression solver (``csrc/l1r_lr.cc`` through
``evaluate/l1r_native.py``: liblinear's newGLMNET) against the port's Python
solver (``evaluate/lexicon.py::_solve_l1r_lr``, the same algorithm) and
scikit-learn's liblinear as the JAX package calls it, on the CPU. The C++
library builds here with g++.

- A dense problem with a unique minimiser: the three fits agree on the
  weights and the objective within what the shared stopping rule allows.
- The adversarial problem ``eval-prepare`` fits for NT, at its real size:
  the committed yelp train beside a copy with 40% of its words replaced.
  Degenerate, so held on the objective (liblinear's x (1 + 5e-5), the bound
  of tests/test_torch_eval_lexicon.py, where the yelp lexicon fit is a case
  for each solver).
- Each fit meets newGLMNET's stopping rule, recomputed from its weights,
  also on two near-separable problems (one the chip script's phase 7
  matrix: the yelp train beside a one-epoch generator's transfers, kept as
  a fixture) where the objectives of different coordinate orders spread
  wider than 5e-5, liblinear's too; each fit lies within twice
  liblinear's spread of its best.
- The same seed gives the same weights; another seed another order.
- A missing or broken compiler raises; nothing falls back to Python.
- ``prefer_native=False`` reaches the Python solver, through the LR and the
  eval harness's entry points."""

import gzip
import os
from collections import Counter

import numpy as np
import pytest
from scipy import sparse
from scipy.special import expit

from consistent__style_transfer_torch.evaluate import l1r_native
from consistent__style_transfer_torch.evaluate import lexicon as plex
from consistent__style_transfer_torch.evaluate.naturalness import (
    adversarial_train_set,
    train_adversarial_lr,
)
from consistent__style_transfer_torch.text import native
from consistent__style_transfer_torch.utils.interop import l1_lr_from_arrays
from test_torch_eval_lexicon import YELP, _liblinear

STOP_SLACK = 1e-6  # chip_smoke.py's: the rounding of a fresh exp(X.w)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _dense_problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 20))
    w_true = rng.normal(size=20) * (rng.random(20) < 0.6)
    y = (rng.random(400) < expit(X @ w_true + 0.3)).astype(np.float64)
    return X, y


def _stopping_radius(X, y, C, fits) -> tuple[float, float]:
    """(r, objective gap) a fit that met the stopping rule can lie from the
    minimiser w*: it stops once the sum of the min-norm subgradient's
    entries is at most eps * G0 (G0: that sum at w = 0), so for an objective
    mu-strongly convex there ||w - w*||_2 <= eps * G0 / mu = r and F(w) - F*
    <= ||g||_2 * ||w - w*||_2 <= (eps * G0)**2 / mu. mu: half the least
    eigenvalue of C * Xb^T diag(p (1 - p)) Xb over the fits (the Hessian
    moves little over a segment of length r)."""
    Xb = np.hstack([X, np.ones((len(X), 1))])
    s = np.where(y == 1, 1.0, -1.0)
    pos = int((s > 0).sum())
    eps = plex.TOL * min(pos, len(s) - pos) / len(s)
    grad0 = C * (Xb[s < 0].sum(0) - 0.5 * Xb.sum(0))  # the loss's gradient at w = 0
    G0 = float(np.maximum(np.abs(grad0) - 1.0, 0.0).sum())
    mus = []
    for lr in fits:
        p = expit(Xb @ np.append(lr.coef_[0], lr.intercept_))
        mus.append(np.linalg.eigvalsh(C * (Xb.T * (p * (1 - p))) @ Xb)[0])
    mu = 0.5 * min(mus)
    return eps * G0 / mu, (eps * G0) ** 2 / mu


def test_dense_problem_three_solvers_agree():
    """400 x 20 Gaussian features, C = 3: the C++, Python and liblinear fits
    lie within 2r of each other (each within r of the minimiser, L2) and
    their objectives within the gap bound; each stopped by its rule, not by
    the iteration cap."""
    X, y = _dense_problem()
    fits = {"native": plex.L1LogisticRegression(C=3, seed=0).fit(X, y),
            "python": plex.L1LogisticRegression(C=3, seed=0, prefer_native=False).fit(X, y)}
    sk = _liblinear(X, y)
    fits["liblinear"] = l1_lr_from_arrays(sk.coef_, sk.intercept_, sk.classes_)
    r, gap = _stopping_radius(X, y, 3.0, fits.values())
    assert 0 < r < 1e-2 * np.linalg.norm(np.append(fits["native"].coef_, 1)), r
    assert fits["native"].n_iter_ < plex.MAX_NEWTON_ITER
    assert fits["python"].n_iter_ < plex.MAX_NEWTON_ITER and sk.n_iter_[0] < 100
    w = {k: np.append(lr.coef_[0], lr.intercept_) for k, lr in fits.items()}
    objs = {k: lr.objective(X, y) for k, lr in fits.items()}
    assert np.count_nonzero(w["native"]) >= 5
    for a, b in (("native", "python"), ("native", "liblinear"), ("python", "liblinear")):
        assert np.linalg.norm(w[a] - w[b]) <= 2 * r, (a, b, np.linalg.norm(w[a] - w[b]), r)
        assert abs(objs[a] - objs[b]) <= gap, (a, b, objs, gap)


@pytest.fixture(scope="module")
def adversarial_problem():
    ori = [line.strip() for k in (0, 1) for line in open(f"{YELP}/style.train.{k}")]
    rng = np.random.default_rng(0)
    words = sorted({w for s in ori for w in s.split()})
    tsf = [" ".join(words[rng.integers(len(words))] if rng.random() < 0.4 else w
                    for w in s.split()) for s in ori]
    x, _ = plex.load_train_set(f"{YELP}/style.train.0", f"{YELP}/style.train.1")
    vec = plex.BinaryUnigramVectorizer().fit(x)
    xs, ys = adversarial_train_set(tsf, ori)
    return vec.transform(xs), ys


def test_adversarial_problem_reaches_liblinear(adversarial_problem):
    """64,000 sentences x 3,053 features, the fit behind NT: the C++
    objective at or below liblinear's x (1 + 5e-5)."""
    X, y = adversarial_problem
    assert X.shape == (64_000, 3053)
    port = plex.L1LogisticRegression(C=3, seed=0).fit(X, y)
    sk = _liblinear(X, y)
    want = l1_lr_from_arrays(sk.coef_, sk.intercept_, sk.classes_).objective(X, y)
    assert port.objective(X, y) <= want * (1 + 5e-5), (port.objective(X, y), want)
    assert 1 <= port.n_iter_ < plex.MAX_NEWTON_ITER and port.n_inner_iter_ >= port.n_iter_
    violation, bound = port.stopping_violation(X, y)
    assert violation <= bound * (1 + STOP_SLACK), (violation, bound)


def _near_separable_problem():
    """2,000 yelp train lines a style beside as many "transfers", 99.5% of
    them 2-5 draws from the 3 most frequent words (as a generator a few
    steps into training writes "i is and and and ."): the fit's
    objective is flat near its minimum, so the stopping rule leaves it
    apart from one coordinate order to the next."""
    ori = [line.strip() for k in (0, 1) for line in list(open(f"{YELP}/style.train.{k}"))[:2000]]
    rng = np.random.default_rng(1)
    top = [w for w, _ in Counter(w for s in ori for w in s.split()).most_common(3)]
    tsf = [" ".join(top[i] for i in rng.integers(0, 3, rng.integers(2, 6)))
           if rng.random() < 0.995 else s for s in ori]
    xs, ys = adversarial_train_set(tsf, ori)
    return plex.BinaryUnigramVectorizer().fit(ori).transform(xs), ys


def _one_epoch_problem():
    """The adversarial matrix ``chip_smoke.py``'s phase 7 fits: the yelp
    train split beside its transfers by a generator trained one epoch a
    stage (``fixtures/yelp_one_epoch.train.{0,1}.tsf.gz``, written by phase
    6 on an H100: lines such as "i is and and and ."), through the yelp
    lexicon's vectorizer; 64,000 x 3,053."""
    ori = [line.strip() for k in (0, 1) for line in open(f"{YELP}/style.train.{k}")]
    tsf = []
    for k in (0, 1):
        with gzip.open(f"{FIXTURES}/yelp_one_epoch.train.{k}.tsf.gz", "rt", encoding="utf-8") as f:
            tsf += [line.strip() for line in f]
    x, _ = plex.load_train_set(f"{YELP}/style.train.0", f"{YELP}/style.train.1")
    xs, ys = adversarial_train_set(tsf, ori)
    return plex.BinaryUnigramVectorizer().fit(x).transform(xs), ys


PROBLEMS = {"dense": _dense_problem, "near_separable": _near_separable_problem,
            "one_epoch": _one_epoch_problem}


@pytest.mark.parametrize("solver", ["native", "python"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_fits_meet_the_stopping_rule(problem, solver):
    """``stopping_violation`` recomputes newGLMNET's optimality violation
    from the weights: each solver's fit meets the rule it stopped by
    (within STOP_SLACK, a fresh exp(X.w) against the solver's running
    one) and the unfitted weights (w = 0) do not. On the near-separable
    problems (the second phase 7's own matrix) the objectives under seeds
    0-2 spread wider than the 5e-5 that the yelp lexicon fits keep,
    liblinear's as well (1.3e-4 and 8.2e-4): the stopping rule, not the
    solver, sets how far apart two fits land, and each of the port's fits
    lies at most twice liblinear's spread above liblinear's best."""
    X, y = PROBLEMS[problem]()
    fits = [plex.L1LogisticRegression(C=3, seed=seed, prefer_native=solver == "native").fit(X, y)
            for seed in (0, 1, 2)]
    for lr in fits:
        violation, bound = lr.stopping_violation(X, y)
        assert lr.n_iter_ < plex.MAX_NEWTON_ITER and violation <= bound * (1 + STOP_SLACK)
    zero = l1_lr_from_arrays(np.zeros_like(fits[0].coef_), [0.0], fits[0].classes_)
    zero.C = 3.0
    violation, bound = zero.stopping_violation(X, y)
    assert violation > 100 * bound
    if problem != "dense":
        objs = [lr.objective(X, y) for lr in fits]
        assert max(objs) / min(objs) - 1 > 5e-5, objs
        sk = [_liblinear(X, y, seed) for seed in (0, 1, 2)]
        sk_objs = [l1_lr_from_arrays(m.coef_, m.intercept_, m.classes_).objective(X, y)
                   for m in sk]
        best, spread = min(sk_objs), max(sk_objs) / min(sk_objs) - 1
        assert spread > 5e-5, sk_objs  # liblinear's own seeds too
        assert max(objs) <= best * (1 + 2 * spread), (objs, sk_objs)


def test_same_seed_same_weights():
    """On the yelp lexicon problem: a seed fixes the coordinate order, so
    the weights; another seed draws another order, which on this degenerate
    problem lands on other weights at an objective within 5e-5 (liblinear's
    own seeds spread 4.4e-5 here)."""
    x, y = plex.load_train_set(f"{YELP}/style.train.0", f"{YELP}/style.train.1")
    X = plex.BinaryUnigramVectorizer().fit(x).transform(x)
    a, b, c = (plex.L1LogisticRegression(C=3, seed=seed).fit(X, y) for seed in (0, 0, 1))
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.intercept_, b.intercept_)
    assert (a.n_iter_, a.n_inner_iter_) == (b.n_iter_, b.n_inner_iter_)
    assert not np.array_equal(a.coef_, c.coef_)
    assert abs(a.objective(X, y) - c.objective(X, y)) <= 5e-5 * a.objective(X, y)


@pytest.mark.parametrize("fault", ["missing", "broken"])
def test_compiler_fault_raises_without_fallback(monkeypatch, tmp_path, fault):
    """No g++ on PATH, or one that fails: the fit raises (with the
    compiler's output) and leaves the LR unfitted."""
    if fault == "missing":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    else:
        broken = tmp_path / "g++"
        broken.write_text("#!/bin/sh\necho 'l1r_lr.cc: error: no compiler here' >&2\nexit 1\n")
        broken.chmod(0o755)
        monkeypatch.setattr(native, "compiler", lambda: str(broken))
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        match = "no compiler here"
    monkeypatch.setattr(plex, "_solve_l1r_lr", _refuse)
    X, y = _dense_problem()
    l1r_native.load.cache_clear()
    try:
        lr = plex.L1LogisticRegression(C=3)
        with pytest.raises(RuntimeError, match=match):
            lr.fit(X, y)
        assert lr.coef_ is None
    finally:
        l1r_native.load.cache_clear()


def _refuse(*args, **kwargs):
    raise AssertionError("this solver must not run")


def test_prefer_native_false_reaches_the_python_solver(monkeypatch, tmp_path):
    """``prefer_native=False`` on the LR, ``fit_unigram_lr``,
    ``generate_lexicon`` and ``train_adversarial_lr`` runs
    ``_solve_l1r_lr``; the default runs the C++ solver."""
    calls = []
    python_solver = plex._solve_l1r_lr

    def spy(*args, **kwargs):
        calls.append("python")
        return python_solver(*args, **kwargs)

    X, y = _dense_problem()
    monkeypatch.setattr(plex, "_solve_l1r_lr", spy)
    plex.L1LogisticRegression(C=3, prefer_native=False).fit(X, y)
    assert calls == ["python"]
    neg, pos = tmp_path / "neg.txt", tmp_path / "pos.txt"
    neg.write_text("the food was bad .\nawful service here .\n" * 20)
    pos.write_text("the food was good .\ngreat service here .\n" * 20)
    _, vec = plex.generate_lexicon(str(neg), str(pos), str(tmp_path / "lex.json"),
                                   str(tmp_path / "vec.json"), prefer_native=False)
    lr, parts = train_adversarial_lr(["food food was"] * 30, ["the food was good ."] * 30, vec,
                                     prefer_native=False)
    assert calls == ["python"] * 3 and lr.n_iter_ == parts["newton_iter"] >= 1
    assert parts["solver"] == "python"
    monkeypatch.setattr(plex, "_solve_l1r_lr", _refuse)
    native_lr = plex.L1LogisticRegression(C=3).fit(X, y)
    assert native_lr.n_iter_ >= 1 and np.isfinite(native_lr.coef_).all()


def test_native_binding_checks_its_inputs():
    """The labels must match X's rows; X may come in any sparse format."""
    X, y = _dense_problem()
    Xb = sparse.hstack([sparse.csr_matrix(X), np.ones((len(X), 1))], format="csr")
    s = np.where(y == 1, 1.0, -1.0)
    with pytest.raises(ValueError, match="rows"):
        l1r_native.solve_l1r_lr(Xb, s[:-1], 3.0, 1e-4, 100, 0)
    w, newton, inner = l1r_native.solve_l1r_lr(Xb, s, 3.0, 1e-4, 100, 0)
    assert w.shape == (21,) and newton >= 1 and inner >= newton
    want, _, _ = l1r_native.solve_l1r_lr(Xb.tocsc(), s, 3.0, 1e-4, 100, 0)
    np.testing.assert_array_equal(w, want)
