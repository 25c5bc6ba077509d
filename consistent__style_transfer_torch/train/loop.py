"""Epoch runtime: early stopping and throughput counters, the port of the JAX
package's ``train/loop.py`` (the small replacement for pytorch-lightning's
Trainer as the reference uses it: fit loop, EarlyStopping(val_loss),
best-checkpoint-by-hand)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class EarlyStopper:
    """EarlyStopping(monitor=val_loss, mode=min) with PL-0.6 semantics: stop
    after ``patience`` consecutive non-improving validations."""

    def __init__(self, patience: int, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best = float("inf") if mode == "min" else float("-inf")
        self.bad = 0

    def update(self, value: float) -> bool:
        """Returns True if training should stop."""
        improved = value < self.best if self.mode == "min" else value > self.best
        if improved:
            self.best = value
            self.bad = 0
            return False
        self.bad += 1
        return self.bad > self.patience


@dataclass
class Throughput:
    """sentences/s and steps/s on the host clock since creation."""

    sentences: int = 0
    steps: int = 0
    t0: float = field(default_factory=time.time)

    def add(self, n_sentences: int) -> None:
        self.sentences += n_sentences
        self.steps += 1

    def rates(self) -> dict:
        dt = max(time.time() - self.t0, 1e-9)
        return {
            "sentences_per_sec": self.sentences / dt,
            "steps_per_sec": self.steps / dt,
            "wall_s": dt,
        }
