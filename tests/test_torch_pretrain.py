"""The pretrain stage against the JAX package's, on the CPU in float32, with
the same weights and the same numpy batches: one step's losses, gradients
and clipped Adam update; a frozen tower's two steps; the eval losses over
the tiny dev split (noise, WMD labels, collate, models and losses together);
and ``run_pretrain`` end to end, whose checkpoints both packages read.
Dropout is off on both sides where numbers are compared (its random streams
differ between the frameworks)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.data import pipeline as jax_pipeline  # noqa: E402
from consistent__style_transfer_tpu.data import wmd_labels as jax_wmd  # noqa: E402
from consistent__style_transfer_tpu.data.corpus import StyleCorpus as JaxCorpus  # noqa: E402
from consistent__style_transfer_tpu.text import word2vec as jax_w2v  # noqa: E402
from consistent__style_transfer_tpu.text.bpe import BPETokenizer as JaxBPE  # noqa: E402
from consistent__style_transfer_tpu.train import common as jax_common  # noqa: E402
from consistent__style_transfer_tpu.train.pretrain import (  # noqa: E402
    make_pretrain_steps as jax_make_pretrain_steps,
)
from consistent__style_transfer_tpu.train.state import TrainState  # noqa: E402
from consistent__style_transfer_tpu.train.state import adam_with_clip as jax_adam_with_clip  # noqa: E402
from consistent__style_transfer_tpu.utils import torch_interop  # noqa: E402
from consistent__style_transfer_torch.config import config_from_args, make_config  # noqa: E402
from consistent__style_transfer_torch.data import pipeline  # noqa: E402
from consistent__style_transfer_torch.data import wmd_labels  # noqa: E402
from consistent__style_transfer_torch.data.corpus import StyleCorpus  # noqa: E402
from consistent__style_transfer_torch.data.prefetch import to_device  # noqa: E402
from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM  # noqa: E402
from consistent__style_transfer_torch.text import word2vec  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.train.pretrain import TASKS, make_pretrain_steps, run_pretrain  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import interop  # noqa: E402

L, B, V_RAND = 10, 4, 40
BOOK_L = 30  # the book preset's max_len (config.py)
SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)
TO_SD = {"cls": interop.classifier_state_dict_from_jax, "mat": interop.matcher_state_dict_from_jax,
         "dn": interop.lm_state_dict_from_jax}
ALL = (True, True, True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _jax_models(V, max_len=L):
    """JAX scorers (float32, 1 layer, d=16) and one jitted (losses,
    gradients) function over them, compiled once per flags tuple."""
    cfg = jax_make_config("tiny", dtype="float32", max_len=max_len, **SCORER)
    models = {"cls": jax_common.build_classifier(cfg, V), "mat": jax_common.build_matcher(cfg, V),
              "dn": jax_common.build_lm(cfg, V)}
    _, eval_step = jax_make_pretrain_steps(models)

    @functools.partial(jax.jit, static_argnames=("flags",))
    def loss_and_grads(params, batch, flags):
        def total(p):
            parts = eval_step(p, batch, flags)
            return sum(parts.values()), parts

        (_, parts), grads = jax.value_and_grad(total, has_aux=True)(params)
        return parts, grads

    return models, loss_and_grads


def _jax_towers(V, seed=0, max_len=L):
    """JAX scorers and their initial params from ``seed``."""
    models, _ = _jax_models(V, max_len)
    kc, km, kd = jax.random.split(jax.random.PRNGKey(seed), 3)
    ln = max_len + max(4, max_len // 2)
    x0, n0 = jnp.zeros((2, max_len), jnp.int32), jnp.zeros((2, ln), jnp.int32)
    params = {"cls": models["cls"].init(kc, x0), "mat": models["mat"].init(km, n0, n0),
              "dn": models["dn"].init(kd, x0)}
    return models, _np(params)


def _port_towers(V, params, p_drop=0.0):
    """The port's scorers holding the JAX params, dropout rate ``p_drop``."""
    models = {"cls": TextCNN(V, p_drop=p_drop), "mat": PairMatcher(V, p_drop=p_drop, **PORT_SIZE),
              "dn": TransformerLM(V, p_drop=p_drop, **PORT_SIZE)}
    for t in TASKS:
        models[t].load_state_dict(TO_SD[t](params[t]), strict=True)
    return models


def _batch(seed, V, max_len=L):
    rng = np.random.default_rng(seed)
    ln = max_len + max(4, max_len // 2)
    return {"x": rng.integers(3, V, (B, max_len)).astype(np.int32),
            "nx1": rng.integers(3, V, (B, ln)).astype(np.int32),
            "nx2": rng.integers(3, V, (B, ln)).astype(np.int32),
            "nx3": rng.integers(3, V, (B, max_len)).astype(np.int32),
            "labels": rng.integers(0, 2, B).astype(np.int32),
            "wmd": rng.uniform(0, 2, B).astype(np.float32)}


def _tensors(batch):
    return to_device(batch, torch.device("cpu"))


def _jax_loss_and_grads(V, params, batch, flags, max_len=L):
    """JAX per-task losses and gradients of their sum, dropout off."""
    parts, grads = _jax_models(V, max_len)[1](params, {k: jnp.asarray(v) for k, v in batch.items()},
                                              flags)
    return {t: float(v) for t, v in parts.items()}, _np(grads)


def _port_named(models):
    return {t: dict(models[t].named_parameters()) for t in TASKS}


def _assert_close_rel(got, want, rel, msg):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{msg}: max abs err {err} vs {rel} x {scale}"


@pytest.mark.parametrize("max_len", [L, BOOK_L], ids=["tiny", "book"])
def test_one_step_losses_and_gradients_match_jax(max_len):
    """Losses within 1e-5, each gradient within 1e-4 of its largest entry;
    at the tiny width and at book's L=30 (noise width 45)."""
    _, params = _jax_towers(V_RAND, max_len=max_len)
    batch = _batch(1, V_RAND, max_len)
    want_parts, want_grads = _jax_loss_and_grads(V_RAND, params, batch, ALL, max_len)
    models = _port_towers(V_RAND, params)
    opt = AdamWithClip([p for t in TASKS for p in models[t].parameters()], 1e-4, clip=1e9)
    train_step, _ = make_pretrain_steps(models, opt)
    parts = train_step(_tensors(batch), ALL)
    assert sorted(parts) == sorted(want_parts)
    for t in TASKS:
        assert parts[t].item() == pytest.approx(want_parts[t], rel=1e-5, abs=1e-5), t
        named = _port_named(models)[t]
        for k, g in TO_SD[t](want_grads[t]).items():
            _assert_close_rel(named[k].grad.numpy(), g.numpy(), 1e-4, f"{t}.{k}")


def test_adam_with_clip_equals_optax():
    """Two steps with a clip that triggers (global norm ~ 40 against 1.0):
    the same parameters within 1e-6."""
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10).astype(np.float32) for s in shapes] for _ in range(2)]
    tx = jax_adam_with_clip(1e-2, 1.0)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamWithClip(tp, 1e-2, 1.0)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, x in zip(tp, g):
            p.grad.copy_(torch.from_numpy(x))
        opt.step()
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_frozen_tower_moves_as_under_optax():
    """Step 1 trains all three towers, step 2 freezes the matcher. The port's
    step gives the frozen tower zero gradients and still moves it on Adam's
    moments. On the same gradients (JAX's, whose frozen-tower gradients are
    zeros too) the port's optimizer puts every tower where optax puts it,
    within 1e-6 with lr 1e-3. (Its own gradients differ from JAX's in the
    last bits, which Adam's sign-like step turns into up to 2 lr on entries
    whose gradient is near zero, so the update rule is held on equal
    gradients; the gradients themselves are held above.)"""
    _, params = _jax_towers(V_RAND, seed=3)
    models, mirror = _port_towers(V_RAND, params), _port_towers(V_RAND, params)
    train_step, _ = make_pretrain_steps(models, AdamWithClip(
        [p for t in TASKS for p in models[t].parameters()], 1e-3, 5.0))
    opt = AdamWithClip([p for t in TASKS for p in mirror[t].parameters()], 1e-3, 5.0)
    state = TrainState.create(jax.tree.map(jnp.asarray, params), jax_adam_with_clip(1e-3, 5.0))
    for seed, flags in ((4, ALL), (5, (True, False, True))):
        batch = _batch(seed, V_RAND)
        before = {k: v.detach().clone() for k, v in models["mat"].named_parameters()}
        train_step(_tensors(batch), flags)
        _, grads = _jax_loss_and_grads(V_RAND, _np(state.params), batch, flags)
        state = state.apply_gradients(jax.tree.map(jnp.asarray, grads))
        opt.zero_grad()
        for t in TASKS:
            named = _port_named(mirror)[t]
            for k, g in TO_SD[t](grads[t]).items():
                named[k].grad.copy_(g)
        opt.step()
    assert not any(np.asarray(g).any() for g in jax.tree.leaves(grads["mat"]))
    for k, p in models["mat"].named_parameters():
        assert not p.grad.any(), k
    assert all(not torch.equal(p, before[k]) for k, p in models["mat"].named_parameters())
    final = _np(state.params)
    for t in TASKS:
        named = _port_named(mirror)[t]
        for k, want in TO_SD[t](final[t]).items():
            np.testing.assert_allclose(named[k].detach().numpy(), want.numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{t}.{k}")


def test_dropout_on_in_train_steps_off_in_eval_steps():
    _, params = _jax_towers(V_RAND, seed=6)
    models = _port_towers(V_RAND, params, p_drop=0.5)
    opt = AdamWithClip([p for t in TASKS for p in models[t].parameters()], 0.0, 5.0)
    train_step, eval_step = make_pretrain_steps(models, opt)
    batch = _tensors(_batch(7, V_RAND))
    a, b = eval_step(batch, ALL), eval_step(batch, ALL)
    for t in TASKS:
        assert a[t].item() == b[t].item()
    trained = train_step(batch, ALL, torch.Generator().manual_seed(0))
    assert all(trained[t].item() != a[t].item() for t in TASKS)


def test_bf16_autocast_keeps_float32_parameters():
    """bfloat16 compute under autocast, float32 master parameters; losses
    within 5% of float32 (bf16 keeps about 3 significant digits)."""
    _, params = _jax_towers(V_RAND, seed=8)
    batch = _tensors(_batch(9, V_RAND))
    f32 = _port_towers(V_RAND, params)
    _, eval32 = make_pretrain_steps(f32, AdamWithClip(
        [p for t in TASKS for p in f32[t].parameters()], 1e-4, 5.0))
    want = eval32(batch, ALL)
    models = _port_towers(V_RAND, params)
    opt = AdamWithClip([p for t in TASKS for p in models[t].parameters()], 1e-4, 5.0)
    train_step, _ = make_pretrain_steps(models, opt, autocast_dtype=torch.bfloat16)
    got = train_step(batch, ALL)
    for t in TASKS:
        assert got[t].item() == pytest.approx(want[t].item(), rel=5e-2), t
        assert all(p.dtype == torch.float32 for p in models[t].parameters())
        assert all(torch.isfinite(p.grad).all() for p in models[t].parameters())


@pytest.fixture(scope="module")
def tiny_pipelines(tiny_corpus, tmp_path_factory):
    """One BPE dump and one word2vec file, read by both packages."""
    root = tmp_path_factory.mktemp("pretrain_tiny")
    files = [os.path.join(tiny_corpus, f"style.train.{i}") for i in (0, 1)]
    JaxBPE.train(files, 120).save(str(root), "tiny")
    paths = (str(root / "tiny-vocab.json"), str(root / "tiny-merges.txt"))
    jtok, tok = JaxBPE.load(*paths), BPETokenizer.load(*paths)
    w2v_path = str(root / "w2v.npz")
    jax_w2v.train_token_w2v(files, jtok, epochs=2, seed=1, prefer_native=False, dim=16,
                            min_count=1).save(w2v_path)
    jw, w = jax_w2v.Word2Vec.load(w2v_path), word2vec.Word2Vec.load(w2v_path)
    jw.init_sims()
    w.init_sims()
    dev = [os.path.join(tiny_corpus, f"style.dev.{i}") for i in (0, 1)]
    jit = jax_pipeline.make_batches(
        JaxCorpus.from_files(dev, jtok, L), 3, L, "pretrain", shuffle=False, seed=0,
        wmd_labeler=jax_wmd.SinkhornWmdLabeler(jw, jtok, max_atoms=L + L // 2))
    it = pipeline.make_batches(
        StyleCorpus.from_files(dev, tok, L), 3, L, "pretrain", shuffle=False, seed=0,
        wmd_labeler=wmd_labels.SinkhornWmdLabeler(w, tok, max_atoms=L + L // 2))
    return len(tok), jit, it


def test_dev_eval_losses_match_jax(tiny_pipelines):
    """The slice as a whole: the same dev batches (noise draws exactly, WMD
    labels within 1e-4) through both eval steps; per-task means over the
    real rows within 1e-4."""
    V, jit, it = tiny_pipelines
    jmodels, params = _jax_towers(V, seed=10)
    _, jax_eval = jax_make_pretrain_steps(jmodels)
    models = _port_towers(V, params)
    _, eval_step = make_pretrain_steps(models, AdamWithClip(
        [p for t in TASKS for p in models[t].parameters()], 1e-4, 5.0))
    totals, jtotals, weights = {t: 0.0 for t in TASKS}, {t: 0.0 for t in TASKS}, 0
    batches = list(zip(jit, it))
    assert len(batches) == len(it) == 3 and batches[-1][1].valid == 2  # 8 sentences, B=3
    for jb, b in batches:
        assert jb.valid == b.valid
        for k in ("x", "nx1", "nx2", "nx3", "labels"):
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        np.testing.assert_allclose(b["wmd"].numpy(), np.asarray(jb["wmd"]), rtol=1e-4, atol=1e-4)
        jparts = jax_eval(params, jax_pipeline.eval_arrays(jb), ALL)
        parts = eval_step(to_device(pipeline.eval_arrays(b), torch.device("cpu")), ALL)
        for t in TASKS:
            totals[t] += parts[t].item() * b.valid
            jtotals[t] += float(jparts[t]) * jb.valid
        weights += b.valid
    for t in TASKS:
        assert totals[t] / weights == pytest.approx(jtotals[t] / weights, rel=1e-4, abs=1e-4), t


def test_run_pretrain_writes_checkpoints_both_packages_read(tiny_corpus, tmp_path):
    cfg = make_config("tiny", data_dir=os.path.dirname(tiny_corpus), dump_dir=str(tmp_path / "dump"),
                      log_dir=str(tmp_path / "log"), device="cpu", dtype="float32", max_len=L,
                      batch_size=4, vocab_size=120, epochs=2, **SCORER)
    paths = run_pretrain(cfg, progress=False)
    assert sorted(paths) == sorted(TASKS)
    V = len(BPETokenizer.load(*cfg.vocab_paths))
    _, params = _jax_towers(V)
    for t, cls, kw in (("cls", TextCNN, {}), ("mat", PairMatcher, PORT_SIZE),
                       ("dn", TransformerLM, PORT_SIZE)):
        assert paths[t] == os.path.join(cfg.ds_dump_dir, "pretrain", f"{t}.pth")
        sd = torch.load(paths[t], map_location="cpu", weights_only=True)
        cls(V, **kw).load_state_dict(sd, strict=True)
        kind = {"cls": "classifier", "mat": "matcher", "dn": "lm"}[t]
        loaded = torch_interop.load_pth(paths[t], params[t], kind)
        back = TO_SD[t](_np(loaded))
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=f"{t}.{k}")
    with open(os.path.join(cfg.log_dir, "tiny", "pretrain", "events.jsonl")) as f:
        assert sum('"val_loss"' in line for line in f) >= 1


def test_config_from_args_parses_bool_and_optional_int():
    cfg = config_from_args(["--sinkhorn_wmd", "false", "--scorer_layers", "3", "--epochs", "2"])
    assert cfg.sinkhorn_wmd is False and cfg.scorer_layers == 3 and cfg.epochs == 2
    assert cfg.scorer_d_model is None
    assert config_from_args(["--sinkhorn_wmd", "1"]).sinkhorn_wmd is True
    assert make_config("yelp").w2v_path == "dump/yelp/yelp-w2v.npz"
