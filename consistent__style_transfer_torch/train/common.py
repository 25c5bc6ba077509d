"""Shared stage plumbing: device, mesh and dtype resolution, the random
streams of a rank, tokenizer, word2vec and corpus loading, model
construction."""

from __future__ import annotations

import contextlib
import os

import torch

from ..config import BACKBONES, Config
from ..data.corpus import StyleCorpus
from ..models import DenoiseSeq2Seq, PairMatcher, RelGANDiscriminator, TextCNN, TransformerLM
from ..models import lfm2_moe
from ..models.lfm2_moe import Lfm2MoeGenerator
from ..models.seq2seq_transformer import TransformerSeq2Seq, generate
from ..parallel.mesh import barrier, is_main, make_mesh
from ..parallel.sharding import data_index, data_size
from ..text.bpe import BPETokenizer, train_tokenizer
from ..text.native import NativeBPE
from ..text.word2vec import Word2Vec, train_token_w2v


# the random streams of a data-parallel run (see rank_generators)
COIN_SEED_OFFSET = 20_000_000
RANK_SEED_STRIDE = 1_000_003


def get_device(cfg: Config) -> torch.device:
    """The device an entry point runs on: ``cfg.device`` (``cuda`` unless
    the caller asked for the CPU), ``cuda:LOCAL_RANK`` for a bare ``cuda``
    under the launcher. Raises when CUDA is asked for and absent; it never
    falls back to the CPU."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu (Config.device='cpu') "
                           "to run on the CPU")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def get_mesh(cfg: Config, device: torch.device):
    """The run's ``(data, model)`` mesh (``parallel/mesh.py::make_mesh``):
    None in one process without a group. Raises when ``cfg.mesh`` does not
    fit the world."""
    return make_mesh(cfg.mesh.n_data, cfg.mesh.n_model, device.type)


def rank_generators(seed: int, device: torch.device, mesh
                    ) -> tuple[torch.Generator, torch.Generator | None]:
    """(the dropout stream, the coin stream) of this rank.

    One process, or one data rank: one generator seeded ``seed`` draws both,
    as it always has, and the coin stream is None (the caller then draws the
    coins from the dropout stream), so such a run draws what a run without
    the launcher draws. ``D`` > 1 data ranks: every rank's rows need their
    own dropout masks, while a sched coin is one draw a decode step for the
    whole global batch. So the dropout stream is seeded by the data index
    (``seed`` at index 0) and the coins come from a second stream, seeded
    ``seed + COIN_SEED_OFFSET`` alike on every rank. Ranks that differ only
    in their model index draw alike (they hold the same rows)."""
    dropout_gen = torch.Generator(device).manual_seed(seed + RANK_SEED_STRIDE * data_index(mesh))
    if data_size(mesh) == 1:
        return dropout_gen, None
    return dropout_gen, torch.Generator(device).manual_seed(seed + COIN_SEED_OFFSET)


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16 or float32, got {cfg.dtype!r}")
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def get_tokenizer(cfg: Config, prefer_native: bool = True) -> NativeBPE | BPETokenizer:
    """Load the dataset tokenizer, training it first if the dump is missing
    (reference ``src/vocab.py:50-65`` CLI behaviour), as the JAX package's
    ``train/common.py:29-48`` does: trained and run in C++
    (``text/native.py``; the same tables and ids as the Python tokenizer),
    or in Python when ``prefer_native`` is false. A failed native build
    raises; nothing falls back."""
    vocab_path, merges_path = cfg.vocab_paths
    if is_main() and not (os.path.exists(vocab_path) and os.path.exists(merges_path)):
        train_tokenizer(cfg.train_files(), cfg.vocab_size, prefer_native).save(
            cfg.ds_dump_dir, cfg.dataset)
    barrier()  # under the launcher rank 0 trains the missing dump, then all load it
    tok = BPETokenizer.load(vocab_path, merges_path)
    return NativeBPE.from_python(tok) if prefer_native else tok


def get_w2v(cfg: Config, tokenizer) -> Word2Vec:
    """Load the WMD word2vec, training it first (the native trainer, 10
    epochs) and saving it if the dump is missing (reference ``src/wmd.py:58-75``);
    vectors normalised as ``init_sims(replace=True)``."""
    if is_main() and not os.path.exists(cfg.w2v_path):
        train_token_w2v(cfg.train_files(), tokenizer, epochs=10, seed=cfg.seed).save(cfg.w2v_path)
    barrier()
    w2v = Word2Vec.load(cfg.w2v_path)
    w2v.init_sims()
    return w2v


def get_corpus(cfg: Config, split: str, tokenizer) -> StyleCorpus:
    return StyleCorpus.from_files(cfg.split_files(split), tokenizer, cfg.max_len)


def build_generator(cfg: Config, n_vocab: int, device: torch.device,
                    training: bool = False
                    ) -> DenoiseSeq2Seq | TransformerSeq2Seq | Lfm2MoeGenerator:
    """The generator of ``cfg.backbone`` on ``device`` with fresh weights
    from ``cfg.seed`` (a checkpoint load replaces them), in train mode with
    ``training``, else in eval mode.

    The LSTM and LFM2-8B-A1B (the first ``cfg.lfm2_layers`` of its
    layers): for serving, in the compute dtype; for training, float32
    master parameters, a bfloat16 compute dtype then being autocast's (the
    training stages'); ``rep_penalty`` applies to the LSTM only. The
    transformer keeps float32 parameters and computes in float32 in both,
    as the JAX package's does whatever ``dtype`` says."""
    kw = dict(n_vocab=n_vocab, n_class=cfg.n_class, max_len=cfg.max_len, p_drop=cfg.p_drop,
              seed=cfg.seed)
    if cfg.backbone == "transformer":
        model = TransformerSeq2Seq(**kw).to(device)
        return model.train(training)
    if cfg.backbone == "lfm2_moe":
        with torch.device(device):  # made where it runs: 9.4 GB at the published widths
            model = Lfm2MoeGenerator(n_layers=cfg.lfm2_layers, **kw)
    elif cfg.backbone == "lstm":
        model = DenoiseSeq2Seq(rep_penalty=cfg.rep_penalty, **kw).to(device)
    else:
        raise ValueError(f"backbone must be one of {BACKBONES}, got {cfg.backbone!r}")
    if training:
        return model.train()
    return model.to(dtype=compute_dtype(cfg)).eval()


def autocast(device: torch.device, dtype: torch.dtype):
    """A training step's compute-dtype context: ``torch.autocast`` in
    ``dtype`` over float32 parameters, or nothing for float32. While a CUDA
    graph is being captured it caches no casts (``torch.cuda.graphs``
    requires ``cache_enabled=False`` there); the numbers are the same."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    return torch.autocast(device.type, dtype=dtype, cache_enabled=not capturing)


def one_weight_cast(model):
    """The generator's ``one_cast()`` scope where it has one (the LSTM and
    LFM2-8B-A1B: the calls inside share one cast of its weights), else
    nothing."""
    return model.one_cast() if hasattr(model, "one_cast") else contextlib.nullcontext()


def _scorer_size_kw(cfg: Config) -> dict:
    """Matcher/LM size overrides (``Config.scorer_*``); an empty dict keeps
    the reference dims of the model defaults."""
    kw = {}
    if cfg.scorer_layers is not None:
        kw["n_layers"] = cfg.scorer_layers
    if cfg.scorer_d_model is not None:
        kw["d_model"] = cfg.scorer_d_model
    if cfg.scorer_heads is not None:
        kw["n_heads"] = cfg.scorer_heads
    return kw


# The scorers keep float32 parameters on ``device``; a bfloat16 compute dtype
# is applied by autocast in the stage that runs them (flax's Dense(dtype=bf16)
# over float32 params), never by casting the parameters.
def build_classifier(cfg: Config, n_vocab: int, device: torch.device) -> TextCNN:
    return TextCNN(n_vocab=n_vocab, n_class=cfg.n_class, seed=cfg.seed).to(device)


def build_matcher(cfg: Config, n_vocab: int, device: torch.device) -> PairMatcher:
    return PairMatcher(n_vocab=n_vocab, seed=cfg.seed + 1, **_scorer_size_kw(cfg)).to(device)


def build_lm(cfg: Config, n_vocab: int, device: torch.device) -> TransformerLM:
    return TransformerLM(n_vocab=n_vocab, seed=cfg.seed + 2, **_scorer_size_kw(cfg)).to(device)


def build_discriminator(cfg: Config, n_vocab: int, device: torch.device) -> RelGANDiscriminator:
    return RelGANDiscriminator(n_vocab=n_vocab, seed=cfg.seed + 99).to(device)


def generator_call(model, inp, label_i, x, label, mode: str = "sched", tau: float = 1.0,
                   time_major_out: bool = False, generator: torch.Generator | None = None,
                   coins: torch.Tensor | None = None):
    """Generator invocation with the reference call semantics (inp,
    input-style, teacher x, output-style, decode mode), plus the st
    temperature, the soft output layout, the dropout/coin generator and
    given sched coins, for any backbone (JAX ``train/common.py:85-114``).

    The LSTM handles every mode in its forward (``DenoiseSeq2Seq.forward``).
    The transformer and LFM2-8B-A1B run ``sched`` with a teacher as their
    parallel causal pass, which draws no coins (``coins`` is ignored), and
    every other mode through their module's ``generate`` over the
    teacher's length, or ``max_len`` without one; they decode batch-major,
    so ``time_major_out`` on a soft output is a transpose. Integer ids are
    batch-major under all three."""
    if isinstance(model, (TransformerSeq2Seq, Lfm2MoeGenerator)):
        if mode == "sched" and x is not None:
            out = model(inp, label_i, x, label, generator=generator)
        else:
            gen = lfm2_moe.generate if isinstance(model, Lfm2MoeGenerator) else generate
            out = gen(model, inp, label_i, label, mode=mode, tau=tau, generator=generator,
                      L_out=None if x is None else x.shape[1])
        return out.transpose(0, 1) if time_major_out and out.dim() == 3 else out
    return model(inp, label_i, x, label, mode=mode, tau=tau, time_major_out=time_major_out,
                 generator=generator, coins=coins)
