"""Optimize stage, test mode: load the generator checkpoint and transfer the
train and test splits to ``.tsf`` files (reference
``src/main_optimize.py:157-174, 243-255``). Adversarial training comes with a
later slice of the port."""

from __future__ import annotations

import os

from ..config import Config
from .common import build_generator, get_device, get_tokenizer
from .infer import run_inference
from .state import load_state_dict, newest_checkpoint


def load_generator_params(cfg: Config, model) -> str:
    """Test-mode resolution (``main_optimize.py:47-54``): the newest
    ``optimize-<ver>/G_epoch_*.pth``, else ``warmup/G.pth``. Loads it into
    ``model`` with ``strict=True`` and returns its path; raises when neither
    exists (test mode never decodes with fresh weights)."""
    if cfg.mode != "test":
        raise NotImplementedError("train-mode loading comes with the optimize slice (ROADMAP.md)")
    path = newest_checkpoint(os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}"))
    if path is None:
        path = os.path.join(cfg.ds_dump_dir, "warmup", "G.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no generator checkpoint: neither {cfg.ds_dump_dir}/optimize-{cfg.ver}/"
                f"G_epoch_*.pth nor {path}")
    model.load_state_dict(load_state_dict(path), strict=True)
    return path


def run_test(cfg: Config) -> list[str]:
    """Test mode: transfer the train and test splits to .tsf files."""
    device = get_device(cfg)
    tokenizer = get_tokenizer(cfg)
    model = build_generator(cfg, len(tokenizer), device)
    load_generator_params(cfg, model)
    return run_inference(cfg, model, tokenizer)
