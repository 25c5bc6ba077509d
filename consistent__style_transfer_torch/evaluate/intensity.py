"""STI — style transfer intensity (reference
``evaluate/auto/transfer_intensity.py``): per pair, the EMD between the style
classifier's class-probability distributions of input and output, sign-flipped
when the output moved *away* from the target style.

The reference's EMD uses an all-ones pyemd distance matrix (ones on the
diagonal too), whose exact value is min(Σp, Σq) ≈ 1 for probability vectors —
so each pair contributes ±1 and STI = 2·direction-accuracy − 1. The port's
copy of the JAX package's ``evaluate/intensity.py`` keeps that closed form
(``ops/emd.py::pyemd_ones_emd``), on the host as the JAX package computes
it."""

from __future__ import annotations

import numpy as np


def class_probs(text: str, model) -> np.ndarray:
    """Class probabilities *sorted by label string* (reference ``:24-28``)."""
    labels, probs = model.predict(text, k=len(model.labels))
    pairs = sorted(zip(labels, np.asarray(probs).tolist()))
    return np.array([p for _, p in pairs])


def direction_corrected_emd(p_in: np.ndarray, p_out: np.ndarray, target: int) -> float:
    emd = float(min(p_in.sum(), p_out.sum()))  # pyemd(ones) closed form
    direction = 1.0 if p_out[target] >= p_in[target] else -1.0
    return emd * direction


def calculate_stis(inputs, outputs, target_styles, model) -> list[float]:
    out = []
    for s_in, s_out, tgt in zip(inputs, outputs, target_styles):
        p_in = class_probs(s_in, model)
        p_out = class_probs(s_out, model)
        out.append(direction_corrected_emd(p_in, p_out, int(tgt)))
    return out
