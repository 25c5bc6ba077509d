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
from ..utils import profiling


def validate(batches, runner, device: torch.device, mesh=None, shard: bool = True,
             key=None, inputs: tuple[str, ...] | None = None, static: dict | None = None
             ) -> list[float] | None:
    """The validation losses of a dev iterator, each over its real rows.

    ``runner(batch, key)`` is the stage's eval step through
    ``train/graphs.py::step_runner`` (a CUDA graph replay on the card, one
    per ``key``; the step itself on the CPU). ``batch`` holds a dev batch's
    tensors on ``device``: the keys ``inputs`` (default: all), its
    ``row_mask`` among them, plus ``static``, tensors on the device that
    every batch of this validation shares (warmup's sched coins). It returns
    a list of losses, each a mean over the rows the mask keeps.

    Each loss is weighted by the count of those rows, which the host takes
    from the batch before it is copied (no read from the device), summed on
    the device and read once after the loop: with a ``mesh``, one
    all-reduce of every rank's masked sums and counts
    (``parallel/sharding.py::global_masked_mean``), so ranks with unequal
    real rows (a padded last batch) weigh right and all read the same
    numbers. ``shard`` false: the iterator yields a rank's rows already (the
    pretrain collate). None when there is no batch.

    Every training loop validates at each epoch's end, so there, on the
    card, the pass reads the SM clock (``utils/profiling.py::sm_clock_mhz``)
    for the epoch's log line (:func:`clock_of`) and the span export."""
    sums, weight = [], 0
    for batch in batches:
        arrays = eval_arrays(batch)
        if shard:
            arrays = shard_batch(arrays, mesh)
        if inputs is not None:
            arrays = {k: arrays[k] for k in inputs}
        real = int(arrays["row_mask"].sum())
        losses = runner({**to_device(arrays, device), **(static or {})}, key)
        # a graph's outputs are static buffers that its next replay
        # overwrites: the products are queued on the stream now, before that
        # replay, so the stream orders the two and each keeps its own batch
        sums.append([v * real for v in losses])
        weight += real
    if not sums:
        return None
    losses = global_masked_mean([torch.stack(col).sum() for col in zip(*sums)], weight,
                                data_group(mesh))
    profiling.sm_clock_mhz(device)
    return losses


def clock_of(device: torch.device) -> dict:
    """``{"sm_clock_mhz": ...}``: the card's SM clock at the newest
    validation's end, for a stage's epoch log line; empty off the card or
    without NVML."""
    mhz = profiling.RECORDER.sm_clock if device.type == "cuda" else None
    return {} if mhz is None else {"sm_clock_mhz": mhz}


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
    """sentences/s and steps/s on the host's ``perf_counter`` clock since
    creation."""

    sentences: int = 0
    steps: int = 0
    t0: float = field(default_factory=time.perf_counter)

    def add(self, n_sentences: int) -> None:
        self.sentences += n_sentences
        self.steps += 1

    def rates(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "sentences_per_sec": self.sentences / dt,
            "steps_per_sec": self.steps / dt,
            "wall_s": dt,
        }
