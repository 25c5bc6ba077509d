"""Checkpoint resolution. The port's checkpoints are the reference's own
format: ``.pth`` state dicts (``G.pth``, ``G_epoch_<n>.pth``), which the JAX
package writes through ``utils/torch_interop.py::save_pth``."""

from __future__ import annotations

import glob
import os


def newest_checkpoint(dump_dir: str, pattern: str = "G_epoch_*.pth") -> str | None:
    """Reference test-mode resolution: the lexicographically newest file in
    the task dump dir (``src/main_optimize.py:47-54``; so ``G_epoch_9`` sorts
    after ``G_epoch_10``, as there)."""
    files = sorted(glob.glob(os.path.join(dump_dir, pattern)))
    return files[-1] if files else None
