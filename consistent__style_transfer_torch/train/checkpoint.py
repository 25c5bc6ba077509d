"""Full-train-state checkpoints of the optimize stage (``Config.resume``): the
port of the JAX package's ``train/checkpoint.py`` (orbax there,
``torch.save`` here), a capability the reference lacks (it keeps best
weights only). Retention is the reference's best-only discipline:
``max_to_keep=1``.

One checkpoint is one file, ``state_<step>.pt`` under the directory
(``optimize-<ver>/full_state/``), written to a temporary name and renamed,
so a reader sees a whole file or none; older ones are deleted after the
rename. The weight-only ``.pth`` files stay the cross-stage contract.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any

import torch

_NAME = re.compile(r"state_(\d+)\.pt$")


def _to_cpu(obj):
    """``obj`` with every tensor in it detached and copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class StateCheckpointer:
    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(_NAME.search(p).group(1))
                      for p in glob.glob(os.path.join(self.directory, "state_*.pt"))
                      if _NAME.search(p))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step}.pt")

    def save(self, step: int, payload: dict[str, Any]) -> None:
        """Write ``payload`` (tensors copied to the host) as checkpoint
        ``step``, then keep only the newest ``max_to_keep``."""
        out = self.path(step)
        tmp = f"{out}.{os.getpid()}.tmp"
        torch.save(_to_cpu(payload), tmp)
        os.replace(tmp, out)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict[str, Any] | None:
        """The payload of checkpoint ``step`` (default the newest) on the
        host, or None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)
