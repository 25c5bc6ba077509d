"""Epoch runtime: early stopping and throughput counters, the port of the JAX
package's ``train/loop.py`` (the small replacement for pytorch-lightning's
Trainer as the reference uses it: fit loop, EarlyStopping(val_loss),
best-checkpoint-by-hand), plus the validation pass of every stage."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..data.pipeline import eval_arrays
from ..data.prefetch import to_device
from ..parallel.sharding import data_group, global_masked_mean, shard_batch


def validate(batches, loss_fn, device: torch.device, mesh=None, shard: bool = True
             ) -> list[float] | None:
    """The validation losses of a dev iterator, each over its real rows.

    ``loss_fn(arrays)`` takes a batch's tensors on ``device``, with its
    ``row_mask``, and returns a list of losses, each a mean over the rows
    the mask keeps. Each is weighted by the count of those rows, summed on
    the device and read once after the loop: with a ``mesh``, one
    all-reduce of every rank's masked sums and counts
    (``parallel/sharding.py::global_masked_mean``), so ranks with unequal
    real rows (a padded last batch) weigh right and all read the same
    numbers. ``shard`` false: the iterator yields a rank's rows already (the
    pretrain collate). None when there is no batch."""
    sums, weight = [], 0
    for batch in batches:
        arrays = eval_arrays(batch)
        if shard:
            arrays = shard_batch(arrays, mesh)
        real = int(arrays["row_mask"].sum())
        sums.append([v * real for v in loss_fn(to_device(arrays, device))])
        weight += real
    if not sums:
        return None
    return global_masked_mean([torch.stack(col).sum() for col in zip(*sums)], weight,
                              data_group(mesh))


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
