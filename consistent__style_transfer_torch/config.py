"""Configuration of the port: the JAX package's ``Config``
(``consistent__style_transfer_tpu/config.py``) trimmed to the fields that the
ported slices read (serving, and the pretrain stage), plus ``device``.
Defaults, derived paths and flag parsing are the same, so both packages read
and write one dump/output layout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    dataset: str = "yelp"
    ver: str = "v0"
    mode: str = "train"  # train | test

    # filesystem layout (same contract as the JAX package and the reference)
    data_dir: str = "data"
    dump_dir: str = "dump"
    log_dir: str = "log"
    out_dir: str = "output"

    # model / data
    n_class: int = 2
    p_drop: float = 0.1
    vocab_size: int = 10000
    max_len: int = 18
    batch_size: int = 256

    # pretrain schedule (reference trainer configs)
    epochs: int = 10
    pretrain_lr: float = 1e-4
    pretrain_patience: int = 1
    pretrain_clip: float = 5.0

    seed: int = 0
    dtype: str = "bfloat16"  # compute dtype: bfloat16 (default) | float32
    rep_penalty: float = 0.0  # greedy-decode repetition penalty (alpha >= 0);
    # subtracts alpha*count(token emitted so far) from the logits of content
    # tokens. 0 = off (reference-faithful decode, through the fused head kernel)
    device: str = "cuda"  # cuda (default; raises when absent) | cpu | cuda:<n>
    sinkhorn_wmd: bool = True  # WMD labels by the batched Sinkhorn (the CUDA
    # kernel on the card); False = the exact host LP

    # scorer (Matcher/LM) size overrides; None keeps the reference dims
    # (6 layers, 8 heads, d=512)
    scorer_layers: int | None = None
    scorer_d_model: int | None = None
    scorer_heads: int | None = None

    # derived paths
    @property
    def ds_data_dir(self) -> str:
        return f"{self.data_dir}/{self.dataset}"

    @property
    def ds_dump_dir(self) -> str:
        return f"{self.dump_dir}/{self.dataset}"

    @property
    def vocab_paths(self) -> tuple[str, str]:
        return (
            f"{self.ds_dump_dir}/{self.dataset}-vocab.json",
            f"{self.ds_dump_dir}/{self.dataset}-merges.txt",
        )

    @property
    def w2v_path(self) -> str:
        return f"{self.ds_dump_dir}/{self.dataset}-w2v.npz"

    @property
    def run_out_dir(self) -> str:
        return f"{self.out_dir}/{self.dataset}-{self.ver}"

    def train_files(self) -> list[str]:
        return [f"{self.ds_data_dir}/style.train.0", f"{self.ds_data_dir}/style.train.1"]

    def split_files(self, split: str) -> list[str]:
        return [f"{self.ds_data_dir}/style.{split}.0", f"{self.ds_data_dir}/style.{split}.1"]


DATASET_PRESETS = {
    # reference src/arguments.py:39-46
    "yelp": {"max_len": 18, "batch_size": 256},
    "book": {"max_len": 30, "batch_size": 128},
}


def make_config(dataset: str = "yelp", **overrides) -> Config:
    cfg = Config(dataset=dataset)
    for k, v in {**DATASET_PRESETS.get(dataset, {}), **overrides}.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    return cfg


def config_from_args(argv=None) -> Config:
    """CLI flag parsing with the reference's knob names (one flag per field),
    as the JAX package parses them: a ``bool`` flag is true for 1/true/yes
    and false otherwise, and an ``int | None`` flag takes an int."""
    import argparse

    parser = argparse.ArgumentParser(description="tpu-st (PyTorch port) configuration")
    typemap = {"str": str, "int": int, "float": float,
               "bool": lambda s: s.lower() in ("1", "true", "yes")}
    for f in dataclasses.fields(Config):
        parser.add_argument(f"--{f.name}", type=typemap[str(f.type).replace(" | None", "")])
    args = vars(parser.parse_args(argv))
    dataset = args.pop("dataset", None) or "yelp"
    return make_config(dataset, **{k: v for k, v in args.items() if v is not None})
