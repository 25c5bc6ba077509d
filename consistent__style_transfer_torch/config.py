"""Configuration of the port: the JAX package's ``Config``
(``consistent__style_transfer_tpu/config.py``) trimmed to the fields that the
ported slices read (serving, pretrain, warmup, optimize and the eval
harness), plus ``device``. ``mesh`` (``--n_data`` / ``--n_model``) shapes the
``(data, model)`` process mesh of a run under the PyTorch launcher
(``parallel/mesh.py``).
Defaults, presets, derived paths and flag parsing are the same, so both
packages read and write one dump/output layout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class MeshConfig:
    """The ``(data, model)`` mesh shape (JAX ``config.py:15-20``). Under the
    launcher ``n_data * n_model`` must equal the world size; ``n_data=None``
    puts every rank the model axis leaves on the data axis. Without the
    launcher the world is one process, so any other shape raises."""

    n_data: int | None = None
    n_model: int = 1


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
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # optimize-stage loss weights (reference defaults, src/arguments.py:24-30)
    w_s: float = 0.1
    w_c: float = 0.5
    w_adv: float = 1.0
    w_bt: float = 1.0
    tau: float = 0.1
    gap: float = 0.0

    # schedules
    epochs: int = 10
    pretrain_lr: float = 1e-4
    warmup_lr: float = 1e-3
    optimize_lr: float = 1e-5
    warmup_epochs: int = 1
    warmup_batch_size: int = 512
    d_update_every: int = 4  # D steps every Nth batch (main_optimize.py:85-88)

    # early stopping patience per stage (reference trainer configs)
    pretrain_patience: int = 1
    warmup_patience: int = 1
    optimize_patience: int = 3

    # grad-clip (global norm) per stage
    pretrain_clip: float = 5.0
    warmup_clip: float = 1.0
    optimize_clip: float = 1.0

    seed: int = 0
    dtype: str = "bfloat16"  # compute dtype: bfloat16 (default) | float32
    rep_penalty: float = 0.0  # greedy-decode repetition penalty (alpha >= 0);
    # subtracts alpha*count(token emitted so far) from the logits of content
    # tokens. 0 = off (reference-faithful decode, through the fused head kernel)
    device: str = "cuda"  # cuda (default; raises when absent) | cpu | cuda:<n>
    backbone: str = "lstm"  # generator family: lstm (reference parity) | transformer
    # (T5-small widths; computes in float32 whatever dtype says) | lfm2_moe
    # (LFM2-8B-A1B's widths: conv/GQA hybrid, 32-expert top-4 MoE; follows dtype)
    lfm2_layers: int = 24  # lfm2_moe: the first N of LFM2-8B-A1B's 24 layer_types
    beam_size: int = 1  # >1: beam decode at inference (serve, infer), any backbone
    fuse_gan_steps: bool = False  # reuse the G-step's fake decode for the D
    # step (saves one of the three rollouts per batch; the reference
    # recomputes it under no_grad each batch, so the default stays faithful)
    sinkhorn_wmd: bool = True  # WMD labels by the batched Sinkhorn (the CUDA
    # kernel on the card); False = the exact host LP
    time_major_probs: bool = True  # keep the G-step's soft decode stacks in
    # the decode loop's (L, B, V) layout: the scorers and D transpose after
    # their V->d projection instead of the probs. Losses are layout-invariant
    w_rec: float = 0.0  # optimize-stage self-reconstruction CE weight
    # (copy bias: CE(G(x, s, teacher=x, s), x) added to the G loss; no
    # reference equivalent — content-preservation lever for weak-DAE regimes)
    w_copy: float = 0.0  # copy-regularization on the FREE-RUNNING transfer:
    # -log p(x_t) under the straight-through transfer distribution. Unlike
    # w_rec (teacher-forced) this directly biases the transfer decode toward
    # emitting source tokens; style CE still flips the style-word positions.
    # No reference equivalent — content-preservation lever.
    w_copy_decay: float = 1.0  # per-epoch multiplier on w_copy (fused step's
    # copy_scale): start with a strong copy anchor, decay so the style CE
    # takes over late. 1.0 = constant.
    copy_mask: bool = True  # style-aware w_copy: weight each position by the
    # source token's style-neutrality (data/style_weights.py) so copy
    # pressure skips style-bearing words
    megastep_k: int = 1  # optimize-stage batches per host round: k batches
    # come up in one host-to-device copy and the host synchronises once per
    # k (train/optimize.py). Every step replays the fused step's CUDA graph
    # on the card, whatever k is
    resume: bool = False  # optimize: restore the full train state
    # (optimize-<ver>/full_state/: G and D, both optimizers, the epoch, the
    # best validation loss, the random generators) if present, and write it
    # after every epoch

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


# Named operating-point presets, applied on top of the dataset preset and
# before explicit overrides (the JAX package's table). ``ref_band`` is the
# recipe the JAX package measured inside the reference's published operating
# band on its 540k control corpus; the plain default keeps the reference's
# w_s=0.1 (src/arguments.py:24).
PRESETS = {
    "ref_band": {
        "w_s": 0.0075,
        "w_copy": 0.4,
        "w_copy_decay": 0.6,
        "warmup_epochs": 2,
    },
}


BACKBONES = ("lstm", "transformer", "lfm2_moe")


def make_config(dataset: str = "yelp", preset: str | None = None, **overrides) -> Config:
    cfg = Config(dataset=dataset)
    named = {}
    if preset:
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r} (have {sorted(PRESETS)})")
        named = PRESETS[preset]
    for k, v in {**DATASET_PRESETS.get(dataset, {}), **named, **overrides}.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    if cfg.backbone not in BACKBONES:
        raise ValueError(f"backbone must be one of {BACKBONES}, got {cfg.backbone!r}")
    return cfg


def config_from_args(argv=None) -> Config:
    """CLI flag parsing with the reference's knob names (one flag per field),
    as the JAX package parses them: a ``bool`` flag is true for 1/true/yes
    and false otherwise, and an ``int | None`` flag takes an int.
    ``--n_data`` / ``--n_model`` set ``mesh`` (JAX ``config.py:237-252``)."""
    import argparse

    parser = argparse.ArgumentParser(description="tpu-st (PyTorch port) configuration")
    typemap = {"str": str, "int": int, "float": float,
               "bool": lambda s: s.lower() in ("1", "true", "yes")}
    for f in dataclasses.fields(Config):
        if f.name == "mesh":
            continue
        parser.add_argument(f"--{f.name}", type=typemap[str(f.type).replace(" | None", "")])
    parser.add_argument("--n_data", type=int)
    parser.add_argument("--n_model", type=int)
    parser.add_argument("--preset", choices=sorted(PRESETS),
                        help="named operating-point preset (e.g. ref_band); explicit flags still win")
    args = vars(parser.parse_args(argv))
    dataset = args.pop("dataset", None) or "yelp"
    preset = args.pop("preset", None)
    n_data, n_model = args.pop("n_data", None), args.pop("n_model", None)
    cfg = make_config(dataset, preset=preset, **{k: v for k, v in args.items() if v is not None})
    if n_data is not None:
        cfg.mesh.n_data = n_data
    if n_model is not None:
        cfg.mesh.n_model = n_model
    return cfg
