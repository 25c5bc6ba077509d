"""The optimize stage against the JAX package's, on the CPU in float32: the
loss primitives ``bce_with_logits`` and ``masked_row_mean``, the style
weights, and ``val_step`` with a ``row_mask`` on the same weights; then
``run_optimize`` end to end on the tiny corpus: the best ``G_epoch_<n>.pth``
kept and the previous one deleted, the patience stop, D's cadence, the
frozen scorers it needs, the warmup G it starts from, and the test-mode
``infer`` that reads its checkpoint. (One ``fused_step`` against the JAX
package's is in test_torch_optimize_step.py.)

``val_step`` decodes without dropout and without sched coins on both sides
(``deterministic=True`` in the JAX package, eval mode in the port), so no
patch is needed here.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.data.corpus import StyleCorpus as JaxCorpus  # noqa: E402
from consistent__style_transfer_tpu.data.style_weights import (  # noqa: E402
    style_neutrality_weights as jax_style_weights,
)
from consistent__style_transfer_tpu.ops import losses as jax_losses  # noqa: E402
from consistent__style_transfer_tpu.train import optimize as jax_optimize  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data.corpus import StyleCorpus  # noqa: E402
from consistent__style_transfer_torch.data.style_weights import style_neutrality_weights  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.ops.losses import bce_with_logits, masked_row_mean  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.train import optimize  # noqa: E402
from consistent__style_transfer_torch.train.common import get_tokenizer  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import interop  # noqa: E402

V, B, L = 30, 4, 6
SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)
ROWS = np.array([1, 1, 0, 1], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU ops: the test workers share the
    cores, and several torch thread pools spinning on them slow every worker
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_primitives_match_jax():
    rng = np.random.default_rng(3)
    z = (rng.normal(size=64) * 30).astype(np.float32)  # large |z| for the stable form
    for t in (np.ones(64, np.float32), np.zeros(64, np.float32),
              rng.uniform(size=64).astype(np.float32)):
        want = float(jax_losses.bce_with_logits(jnp.asarray(z), jnp.asarray(t)))
        got = bce_with_logits(torch.from_numpy(z), torch.from_numpy(t)).item()
        assert got == pytest.approx(want, rel=1e-6)
        ref = torch.nn.functional.binary_cross_entropy_with_logits(torch.from_numpy(z),
                                                                   torch.from_numpy(t)).item()
        assert got == pytest.approx(ref, rel=1e-5)
    v, m = rng.normal(size=7).astype(np.float32), np.array([1, 0, 1, 1, 0, 0, 1], np.float32)
    assert masked_row_mean(torch.from_numpy(v), torch.from_numpy(m)).item() == pytest.approx(
        float(jax_losses.masked_row_mean(jnp.asarray(v), jnp.asarray(m))), rel=1e-6)
    assert masked_row_mean(torch.from_numpy(v), torch.zeros(7)).item() == 0.0


def test_style_neutrality_weights_equal_jax(tiny_corpus, tmp_path):
    files = [os.path.join(tiny_corpus, f"style.train.{i}") for i in (0, 1)]
    BPETokenizer.train(files, 120).save(str(tmp_path), "tiny")
    tok = BPETokenizer.load(str(tmp_path / "tiny-vocab.json"), str(tmp_path / "tiny-merges.txt"))
    corpus = StyleCorpus.from_files(files, tok, 10)
    jcorpus = JaxCorpus(corpus.ids, corpus.lengths, corpus.labels)
    for alpha in (1.0, 0.1):
        got = style_neutrality_weights(corpus, len(tok), alpha=alpha)
        np.testing.assert_array_equal(got, jax_style_weights(jcorpus, len(tok), alpha=alpha))
    assert got.dtype == np.float32 and (got[:3] == 1).all() and got.min() < 0.5


@pytest.fixture(scope="module")
def jax_val():
    """JAX params of the five models and val_step's loss on one batch, with
    and without a row mask."""
    cfg = jax_make_config("tiny", dtype="float32", max_len=L, **SCORER)
    models = jax_optimize.OptimizeModels(cfg, V)
    kc, km, kn, kg = jax.random.split(jax.random.PRNGKey(0), 4)
    x0, l0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    n0 = jnp.zeros((2, L + L // 2), jnp.int32)
    frozen = {"cls": models.classifier.init(kc, x0), "mat": models.matcher.init(km, n0, n0),
              "nt": models.nt_checker.init(kn, x0)}
    g_params = models.generator.init(kg, x0, l0, None, l0, deterministic=True)
    val_step = jax_optimize.make_optimize_steps(cfg, models).val_step
    rng = np.random.default_rng(1)
    batch = {"x": rng.integers(3, V, (B, L)).astype(np.int32),
             "labels": np.array([0, 1, 1, 0], np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"batch": batch, "frozen": to_np(frozen), "g": to_np(g_params),
            "masked": float(val_step(g_params, frozen, dict(jb, row_mask=jnp.asarray(ROWS)))),
            "all": float(val_step(g_params, frozen, jb))}


def test_val_step_with_row_mask_matches_jax(jax_val):
    """st decode in eval mode, argmax tokens, CE(cls) + CE(LM) + mean(mat)
    over the rows of the mask: within 1e-5, and the mask matters."""
    cfg = make_config("tiny", dtype="float32", max_len=L, device="cpu", **SCORER)
    models = SimpleNamespace(generator=DenoiseSeq2Seq(V, 2, L), classifier=TextCNN(V),
                             matcher=PairMatcher(V, **PORT_SIZE),
                             nt_checker=TransformerLM(V, **PORT_SIZE), disc=RelGANDiscriminator(V))
    models.generator.load_state_dict(interop.generator_state_dict_from_jax(jax_val["g"]))
    models.classifier.load_state_dict(interop.classifier_state_dict_from_jax(jax_val["frozen"]["cls"]))
    models.matcher.load_state_dict(interop.matcher_state_dict_from_jax(jax_val["frozen"]["mat"]))
    models.nt_checker.load_state_dict(interop.lm_state_dict_from_jax(jax_val["frozen"]["nt"]))
    steps = optimize.make_optimize_steps(
        cfg, models, AdamWithClip(models.generator.parameters(), 1e-5, 1.0),
        AdamWithClip(models.disc.parameters(), 1e-5, 1.0))
    batch = {k: torch.from_numpy(v) for k, v in jax_val["batch"].items()}
    got = steps.val_step(dict(batch, row_mask=torch.from_numpy(ROWS))).item()
    assert got == pytest.approx(jax_val["masked"], rel=1e-5, abs=1e-5)
    assert steps.val_step(batch).item() == pytest.approx(jax_val["all"], rel=1e-5, abs=1e-5)
    assert abs(jax_val["masked"] - jax_val["all"]) > 1e-4


# ---------------------------------------------------------------- the loop
def _tiny_cfg(tiny_corpus, tmp_path, **kw):
    kw = {"dtype": "float32", **SCORER, **kw}
    return make_config("tiny", data_dir=os.path.dirname(tiny_corpus),
                       dump_dir=str(tmp_path / "dump"), log_dir=str(tmp_path / "log"),
                       out_dir=str(tmp_path / "out"), device="cpu", max_len=6, vocab_size=120,
                       batch_size=4, **kw)


def _pretrain_dumps(cfg) -> int:
    """Seeded scorer checkpoints in the pretrain dump (their values do not
    matter to the loop); returns the vocab size."""
    Vt = len(get_tokenizer(cfg))
    pre = os.path.join(cfg.ds_dump_dir, "pretrain")
    os.makedirs(pre, exist_ok=True)
    for name, m in (("cls", TextCNN(Vt)), ("mat", PairMatcher(Vt, **PORT_SIZE)),
                    ("dn", TransformerLM(Vt, **PORT_SIZE))):
        torch.save(m.state_dict(), os.path.join(pre, f"{name}.pth"))
    return Vt


def _events(cfg):
    with open(os.path.join(cfg.log_dir, cfg.dataset, f"optimize-{cfg.ver}", "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_optimize_keeps_the_best_and_stops_on_patience(tiny_corpus, tmp_path, monkeypatch):
    """Validation losses scripted to 3, 2, 2.5, 2.5, 2.5, 2.5 (the dev split
    is two batches an epoch): G_epoch_0 and then G_epoch_1 saved, G_epoch_0
    deleted, and four epochs without improvement stop the run at patience
    3, after 6 of 10 epochs. Every epoch trains 3 batches (12 sentences,
    B=4) and D applies at epoch-local batches 0 and 2 (d_update_every=2).
    The test-mode infer then decodes from G_epoch_1."""
    cfg = _tiny_cfg(tiny_corpus, tmp_path, epochs=10, d_update_every=2)
    Vt = _pretrain_dumps(cfg)
    scripted = [3.0, 2.0, 2.5, 2.5, 2.5, 2.5]
    make = optimize.make_optimize_steps

    def scripted_steps(*args, **kw):
        steps = make(*args, **kw)
        calls = []

        def val_step(batch):
            steps.val_step(batch)
            calls.append(1)
            return torch.tensor(scripted[(len(calls) - 1) // 2])

        return steps._replace(val_step=val_step)

    monkeypatch.setattr(optimize, "make_optimize_steps", scripted_steps)
    best = optimize.run_optimize(cfg, progress=False)
    task = os.path.join(cfg.ds_dump_dir, "optimize-v0")
    assert best == os.path.join(task, "G_epoch_1.pth")
    assert sorted(os.listdir(task)) == ["G_epoch_1.pth"]
    epochs = [e for e in _events(cfg) if "val_loss" in e]
    assert [e["val_loss"] for e in epochs] == scripted
    assert [e["train_steps"] for e in epochs] == [3] * 6
    assert [e["d_applies"] for e in epochs] == [2] * 6
    DenoiseSeq2Seq(Vt, 2, cfg.max_len).load_state_dict(torch.load(best, weights_only=True),
                                                       strict=True)
    cfg.mode = "test"
    paths = optimize.run_test(cfg)
    assert len(paths) == 4 and all(os.path.exists(p) for p in paths)


def test_run_optimize_logs_finite_losses(tiny_corpus, tmp_path):
    """Two real epochs (bf16 autocast, as by default, with the copy terms on
    and the fused GAN steps): every logged loss is finite, one step a batch,
    and the accumulator carries over the epoch boundary untouched (D applies
    at batch 0 of each epoch whatever came before)."""
    cfg = _tiny_cfg(tiny_corpus, tmp_path, epochs=2, dtype="bfloat16", w_rec=0.5, w_copy=0.5,
                    w_copy_decay=0.5, fuse_gan_steps=True)
    _pretrain_dumps(cfg)
    optimize.run_optimize(cfg, progress=False)
    events = _events(cfg)
    losses = [(k, e[k]) for e in events for k in ("D", "G", "STI", "CP", "BK", "REC", "COPY",
                                                   "loss", "val_loss") if k in e]
    assert {k for k, _ in losses} >= {"D", "G", "STI", "CP", "BK", "REC", "COPY", "val_loss"}
    assert all(np.isfinite(v) for _, v in losses), losses
    epochs = [e for e in events if "val_loss" in e]
    assert [e["train_steps"] for e in epochs] == [3, 3]
    assert [e["d_applies"] for e in epochs] == [1, 1]  # d_update_every=4: batch 0 only


def test_run_optimize_needs_the_pretrain_scorers(tiny_corpus, tmp_path):
    cfg = _tiny_cfg(tiny_corpus, tmp_path, epochs=1)
    with pytest.raises(FileNotFoundError, match="pretrain"):
        optimize.run_optimize(cfg, progress=False)


def test_train_mode_loads_the_warmup_generator(tiny_corpus, tmp_path):
    cfg = _tiny_cfg(tiny_corpus, tmp_path)
    Vt = _pretrain_dumps(cfg)
    model = DenoiseSeq2Seq(Vt, 2, cfg.max_len, seed=0)
    assert optimize.load_generator_params(cfg, model) is None  # the fresh weights stay
    warm = DenoiseSeq2Seq(Vt, 2, cfg.max_len, seed=7)
    path = os.path.join(cfg.ds_dump_dir, "warmup", "G.pth")
    os.makedirs(os.path.dirname(path))
    torch.save(warm.state_dict(), path)
    assert optimize.load_generator_params(cfg, model) == path
    for k, v in model.state_dict().items():
        assert torch.equal(v, warm.state_dict()[k]), k
