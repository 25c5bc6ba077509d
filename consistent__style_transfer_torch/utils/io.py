"""Filesystem and metrics logging: the port of the JAX package's
``utils/io.py``. ``read_lines`` / ``write_lines`` read and write one stripped
sentence a line; ``RunLogger`` is the reference's TensorBoard/TestTube
loggers and hparams snapshots, as a jsonl event stream plus a json hparams
file per run, in the same layout:
``<log_dir>/<stage>[-<ver>]/{events.jsonl,hparams.json}``."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable


def read_lines(path: str) -> list[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f]


def write_lines(lines: Iterable[str], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line.rstrip("\n") + "\n")


class RunLogger:
    """Append-only jsonl metrics stream + hparams snapshot. With ``enabled``
    false (every rank but 0 of a data-parallel run) it writes nothing."""

    def __init__(self, log_dir: str, stage: str, ver: str | None = None, config=None,
                 enabled: bool = True):
        self.enabled = enabled
        if not enabled:
            return
        name = stage if ver is None else f"{stage}-{ver}"
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "events.jsonl")
        self._f = open(self.path, "a", encoding="utf-8")
        if config is not None:
            snap = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
            with open(os.path.join(self.dir, "hparams.json"), "w") as f:
                json.dump(snap, f, indent=2, default=str)

    def log(self, step: int, **metrics) -> None:
        """One event; tensor metrics are read to the host here."""
        if not self.enabled:
            return
        rec = {"t": time.time(), "step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self.enabled:
            self._f.close()
