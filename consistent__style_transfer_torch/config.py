"""Configuration for the ported slice: the JAX package's ``Config``
(``consistent__style_transfer_tpu/config.py``) trimmed to the fields that
serving reads, plus ``device``. Defaults and derived paths are the same, so
both packages read and write one dump/output layout.
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
    out_dir: str = "output"

    # model / data
    n_class: int = 2
    vocab_size: int = 10000
    max_len: int = 18
    batch_size: int = 256

    seed: int = 0
    dtype: str = "bfloat16"  # compute dtype: bfloat16 (default) | float32
    rep_penalty: float = 0.0  # greedy-decode repetition penalty (alpha >= 0);
    # subtracts alpha*count(token emitted so far) from the logits of content
    # tokens. 0 = off (reference-faithful decode, through the fused head kernel)
    device: str = "cuda"  # cuda (default; raises when absent) | cpu | cuda:<n>

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
    """CLI flag parsing with the reference's knob names (one flag per field)."""
    import argparse

    parser = argparse.ArgumentParser(description="tpu-st (PyTorch port) configuration")
    typemap = {"str": str, "int": int, "float": float}
    for f in dataclasses.fields(Config):
        parser.add_argument(f"--{f.name}", type=typemap[str(f.type)])
    args = vars(parser.parse_args(argv))
    dataset = args.pop("dataset", None) or "yelp"
    return make_config(dataset, **{k: v for k, v in args.items() if v is not None})
