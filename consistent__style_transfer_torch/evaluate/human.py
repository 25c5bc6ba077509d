"""Human-evaluation tooling (reference ``evaluate/user/``):

- :func:`sample_blind_csv` — sample N pairs per style per dataset across
  systems, write blind-rating CSVs with style-masked variants
  (``sample_test.py:36-101``);
- :func:`ingest_rated_csv` — read one rater's filled-in CSV (systems
  interleaved cyclically, optional reversed-scale correction,
  ``calculate.py:5-20``);
- :func:`score_rater_files` / :func:`score_ratings` — 1/rank scores averaged
  over raters (``calculate.py:66-79``);
- :func:`kappa_from_rater_files` / :func:`fleiss_kappa` — inter-rater
  agreement (``calculate.py:23-63,80-86``).

The port's copy of the JAX package's ``evaluate/human.py`` (numpy and csv).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..utils.io import read_lines
from .content import mask_style_words


def sample_blind_csv(
    data_dir: str,
    output_dirs: dict[str, str],
    lexicon: set[str],
    out_csv: str,
    n_per_style: int = 50,
    seed: int = 0,
) -> None:
    """For each style file, sample sentence indices and emit one CSV row per
    sample: original, then each system's transfer (column order shuffled per
    row is *not* done in the reference — systems are in fixed dict order),
    plus masked variants for content-only judging."""
    rng = np.random.default_rng(seed)
    rows = []
    systems = list(output_dirs)
    for label in (0, 1):
        originals = read_lines(f"{data_dir}/style.test.{label}")
        transfers = {
            s: read_lines(f"{d}/style.test.{label}.tsf") for s, d in output_dirs.items()
        }
        idx = rng.choice(len(originals), size=min(n_per_style, len(originals)),
                         replace=False)
        for i in idx:
            row = {"style": label, "index": int(i), "original": originals[i]}
            for s in systems:
                row[s] = transfers[s][i]
                row[f"{s}_masked"] = mask_style_words([transfers[s][i]], lexicon)[0]
            rows.append(row)
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def ingest_rated_csv(
    path: str,
    n_systems: int = 3,
    reverse: bool = False,
    metrics: tuple[str, ...] = ("STI", "CP", "NT"),
) -> np.ndarray:
    """Read one rater's filled-in CSV (reference ``calculate.py:5-20``).

    Rows interleave the systems cyclically (row i rates system ``i %
    n_systems``); each row carries 1-based integer ranks in the metric
    columns. ``reverse=True`` corrects a rater who used the reversed scale
    (rank x -> n_systems+1-x, the reference's ``4 - x`` for 3 systems).
    Returns an int array of shape (n_systems, n_items, n_metrics).
    """
    per_system: list[list[list[int]]] = [[] for _ in range(n_systems)]
    with open(path, newline="", encoding="utf-8") as f:
        for i, row in enumerate(csv.DictReader(f)):
            ranks = [int(row[m]) for m in metrics]
            if reverse:
                ranks = [n_systems + 1 - r for r in ranks]
            per_system[i % n_systems].append(ranks)
    counts = {len(s) for s in per_system}
    if len(counts) != 1:
        raise ValueError(
            f"{path}: row count must be a multiple of n_systems="
            f"{n_systems}, got per-system counts {[len(s) for s in per_system]}"
        )
    return np.asarray(per_system, dtype=np.int64)


def score_rater_files(
    rater_files: list[tuple[str, bool]],
    n_systems: int = 3,
    metrics: tuple[str, ...] = ("STI", "CP", "NT"),
) -> np.ndarray:
    """Mean 1/rank per (system, metric), averaged over raters — the
    reference's ``(res_0.mean(1)+res_1.mean(1)+res_2.mean(1))/3``
    (``calculate.py:66-71``). ``rater_files`` is [(csv_path, reverse), ...].
    Returns (n_systems, n_metrics) float scores."""
    per_rater = [
        ranks_to_scores(ingest_rated_csv(p, n_systems, rev, metrics)).mean(axis=1)
        for p, rev in rater_files
    ]
    return np.mean(per_rater, axis=0)


def kappa_from_rater_files(
    rater_files: list[tuple[str, bool]],
    n_systems: int = 3,
    metrics: tuple[str, ...] = ("STI", "CP", "NT"),
) -> float:
    """Fleiss' kappa over every (system, item, metric) rank assignment with
    the raters as judges — the reference's ``create_kappa_mat`` over the
    flattened per-rater sequences + ``fleissKappa(n=3)``
    (``calculate.py:54-63,80-86``)."""
    flat = [
        ingest_rated_csv(p, n_systems, rev, metrics).ravel()
        for p, rev in rater_files
    ]
    n_subjects = flat[0].size
    if any(f.size != n_subjects for f in flat):
        raise ValueError("raters rated different numbers of subjects")
    counts = np.zeros((n_subjects, n_systems), dtype=np.int64)
    for f in flat:
        counts[np.arange(n_subjects), f - 1] += 1
    return fleiss_kappa(counts)


def ranks_to_scores(ranks: np.ndarray) -> np.ndarray:
    """rank r (1-based) -> score 1/r (reference ``calculate.py:66-79``)."""
    return 1.0 / np.asarray(ranks, dtype=np.float64)


def score_ratings(rank_matrix: np.ndarray, systems: list[str]) -> dict[str, float]:
    """rank_matrix: (n_items, n_systems) ranks per item; returns mean 1/rank
    score per system."""
    scores = ranks_to_scores(rank_matrix)
    return {s: float(scores[:, j].mean()) for j, s in enumerate(systems)}


def correlate_with_human(metric_scores: dict[str, np.ndarray],
                         human_scores: np.ndarray) -> dict[str, dict]:
    """Pearson correlation of each automatic metric against human judgments,
    with the 1.96-sigma margin of error on r (reference
    ``evaluate/auto/utils.py:82-98``). Returns {metric: {r, p, error_bound}}."""
    from scipy.stats import linregress

    n = len(human_scores)
    out: dict[str, dict] = {}
    for name, scores in metric_scores.items():
        res = linregress(np.asarray(scores, float), np.asarray(human_scores, float))
        r = float(res.rvalue)
        std_err_r = (1 - r**2) / np.sqrt(n)
        out[name] = {
            "r": r,
            "p": float(res.pvalue),
            "error_bound": float(1.96 * std_err_r),
        }
    return out


def fleiss_kappa(ratings: np.ndarray) -> float:
    """Fleiss' kappa for (n_items, n_categories) count matrix where each row
    sums to the number of raters."""
    ratings = np.asarray(ratings, dtype=np.float64)
    n_items, _ = ratings.shape
    n_raters = ratings[0].sum()
    p_cat = ratings.sum(axis=0) / (n_items * n_raters)
    p_item = ((ratings**2).sum(axis=1) - n_raters) / (n_raters * (n_raters - 1))
    p_bar = p_item.mean()
    p_e = (p_cat**2).sum()
    if p_e == 1.0:
        return 1.0
    return float((p_bar - p_e) / (1 - p_e))
