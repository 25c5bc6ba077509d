"""The warmup stage against the JAX package's, on the CPU in float32: the
warmup batches (bit for bit at one seed), one train step (loss, gradients and
the clipped Adam update) and the row-masked eval loss against
``make_warmup_steps``; and ``run_warmup`` end to end, whose ``G.pth`` the JAX
package's ``load_pth`` and the port's test-mode ``infer`` both read.

Dropout is off on both sides (the JAX generator's ``p_drop`` field is 0, the
port's module has ``p_drop=0``). The JAX generator draws its sched coins from
its "coin" rng inside the jitted step; the tests replace
``jax.random.bernoulli`` while the step is traced (a test-side patch) so that
it uses the coins the port is given."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.data import pipeline as jax_pipeline  # noqa: E402
from consistent__style_transfer_tpu.data.corpus import StyleCorpus as JaxCorpus  # noqa: E402
from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.ops.losses import softmax_cross_entropy_tokens as jax_ce  # noqa: E402
from consistent__style_transfer_tpu.text.bpe import BPETokenizer as JaxBPE  # noqa: E402
from consistent__style_transfer_tpu.train.state import TrainState, adam_with_clip  # noqa: E402
from consistent__style_transfer_tpu.train.warmup import make_warmup_steps as jax_warmup_steps  # noqa: E402
from consistent__style_transfer_tpu.utils import torch_interop  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data import pipeline  # noqa: E402
from consistent__style_transfer_torch.data.corpus import StyleCorpus  # noqa: E402
from consistent__style_transfer_torch.data.prefetch import to_device  # noqa: E402
from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.train import warmup  # noqa: E402
from consistent__style_transfer_torch.train.optimize import run_test  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils.interop import generator_state_dict_from_jax  # noqa: E402

V, B, L = 40, 4, 6
LR, CLIP = 1e-3, 0.1  # a clip below this batch's gradient norm (about 0.33)
COINS = np.array([0, 1, 1, 0, 1, 0], bool)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU ops: the test workers share the
    cores, and several torch thread pools spinning on them slow every worker
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_setup():
    """A JAX generator without dropout, its params, and its two jitted
    warmup steps, traced with the sched coins fixed to ``COINS``."""
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
    x0, l0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), x0, l0, x0, l0,
                                                 deterministic=True))
    train_step, eval_step = jax_warmup_steps(model)

    def grads(p, batch):
        def loss(q):
            logits = model.apply(q, batch["nx"], batch["labels"], batch["x"], batch["labels"],
                                 mode="sched", deterministic=True,
                                 rngs={"coin": jax.random.PRNGKey(2)})
            return jax_ce(logits, batch["x"])
        return jax.value_and_grad(loss)(p)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(COINS[: shape[0]]))
        batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
        # trace (and compile) every JAX function under the patch
        state = TrainState.create(jax.tree.map(jnp.asarray, params), adam_with_clip(LR, CLIP))
        new_state, loss = train_step(state, batch, jax.random.PRNGKey(1), 0)
        want_loss, want_grads = jax.jit(grads)(params, batch)
        masked = dict(batch, row_mask=jnp.asarray([1, 1, 1, 0], jnp.float32))
        eval_loss = eval_step(params, masked, {"coin": jax.random.PRNGKey(3)})
    return {"params": params, "loss": float(loss), "grad_loss": float(want_loss),
            "grads": jax.tree.map(np.asarray, want_grads),
            "new_params": jax.tree.map(np.asarray, new_state.params),
            "eval_loss": float(eval_loss)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"nx": rng.integers(3, V, (B, L)).astype(np.int32),
            "x": rng.integers(3, V, (B, L)).astype(np.int32),
            "labels": np.array([0, 1, 1, 0], np.int32)}


def _port(params):
    model = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
    model.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    return model


def test_warmup_batches_equal_jax_bit_for_bit(tiny_corpus, tmp_path):
    """Two shuffled epochs of warmup batches (transfer_noise at p=0.1 aligned
    to max_len) from one seed: every array equal."""
    files = [os.path.join(tiny_corpus, f"style.train.{i}") for i in (0, 1)]
    JaxBPE.train(files, 120).save(str(tmp_path), "tiny")
    paths = (str(tmp_path / "tiny-vocab.json"), str(tmp_path / "tiny-merges.txt"))
    jit = jax_pipeline.make_batches(JaxCorpus.from_files(files, JaxBPE.load(*paths), 10), 4, 10,
                                    "warmup", shuffle=True, seed=3)
    it = pipeline.make_batches(StyleCorpus.from_files(files, BPETokenizer.load(*paths), 10), 4, 10,
                               "warmup", shuffle=True, seed=3)
    n = 0
    for _ in range(2):
        for jb, b in zip(jit, it, strict=True):
            assert sorted(b.arrays) == sorted(jb.arrays) and b.valid == jb.valid
            for k in jb.arrays:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
            n += 1
    assert n == 6  # 12 sentences, B=4, two epochs
    assert any((b["nx"] != b["x"]).any() for b in it)  # the noise did act


def test_one_train_step_matches_jax(jax_setup):
    """Loss within 1e-5; the gradient as clipped (the global norm here is
    above the clip) within 1e-4 of each parameter's largest entry; the updated
    parameters within 1e-6 where the gradient is above 1e-6, elsewhere
    within 2 lr (Adam's first step is lr times the gradient's sign there, and
    the two frameworks' last bits may give a near-zero entry either sign)."""
    model = _port(jax_setup["params"])
    opt = AdamWithClip(model.parameters(), LR, CLIP)
    train_step, _ = warmup.make_warmup_steps(model, opt)
    loss = train_step(to_device(_batch(0), torch.device("cpu")), coins=torch.from_numpy(COINS))
    assert loss.item() == pytest.approx(jax_setup["loss"], rel=1e-5, abs=1e-5)
    assert jax_setup["grad_loss"] == pytest.approx(jax_setup["loss"], rel=1e-6)
    grads = generator_state_dict_from_jax(jax_setup["grads"])
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    assert norm > CLIP  # the clip acts
    named = dict(model.named_parameters())
    new = generator_state_dict_from_jax(jax_setup["new_params"])
    for k, g in grads.items():
        clipped = g * (CLIP / norm)
        scale = float(clipped.abs().max())
        err = float((named[k].grad - clipped).abs().max())  # the step clips .grad in place
        assert err <= 1e-4 * scale + 1e-10, f"{k}: grad err {err} vs 1e-4 x {scale}"
        diff = (named[k].detach() - new[k]).abs()
        big = g.abs() > 1e-6
        assert big.any(), k
        assert float(diff[big].amax()) <= 1e-6, k
        assert float(diff.max()) <= 2 * LR + 1e-6, k


def test_masked_eval_loss_matches_jax(jax_setup):
    """eval mode, the same coins, the CE over the first three rows: within
    1e-5; the padded fourth row is left out of the mean."""
    _, eval_step = warmup.make_warmup_steps(_port(jax_setup["params"]),
                                            AdamWithClip([torch.zeros(1)], LR, CLIP))
    batch = to_device(dict(_batch(0), row_mask=np.array([1, 1, 1, 0], np.float32)),
                      torch.device("cpu"))
    got = eval_step(batch, torch.from_numpy(COINS)).item()
    assert got == pytest.approx(jax_setup["eval_loss"], rel=1e-5, abs=1e-5)
    full = eval_step({k: v for k, v in batch.items() if k != "row_mask"},
                     torch.from_numpy(COINS)).item()
    assert abs(full - got) > 1e-4


def _cfg(tiny_corpus, tmp_path, **kw):
    return make_config("tiny", data_dir=os.path.dirname(tiny_corpus),
                       dump_dir=str(tmp_path / "dump"), log_dir=str(tmp_path / "log"),
                       out_dir=str(tmp_path / "out"), device="cpu", dtype="float32", max_len=10,
                       vocab_size=120, batch_size=4, warmup_batch_size=4, **kw)


def test_run_warmup_end_to_end_both_packages_read_it(tiny_corpus, tmp_path):
    cfg = _cfg(tiny_corpus, tmp_path, warmup_epochs=2)
    g_path = warmup.run_warmup(cfg, progress=False)
    assert g_path == os.path.join(cfg.ds_dump_dir, "warmup", "G.pth") and os.path.exists(g_path)
    with open(os.path.join(cfg.log_dir, "tiny", "warmup", "events.jsonl")) as f:
        events = [__import__("json").loads(line) for line in f]
    assert [e["train_steps"] for e in events if "val_loss" in e] == [3, 3]  # 12 sentences, B=4
    assert "dn_loss" in events[0] and all(np.isfinite(e.get("val_loss", 0)) for e in events)
    sd = torch.load(g_path, map_location="cpu", weights_only=True)
    Vt = len(BPETokenizer.load(*cfg.vocab_paths))
    DenoiseSeq2Seq(n_vocab=Vt, n_class=2, max_len=10).load_state_dict(sd, strict=True)
    x0, l0 = jnp.zeros((2, 10), jnp.int32), jnp.zeros((2,), jnp.int32)
    template = JaxSeq2Seq(n_vocab=Vt, n_class=2, max_len=10).init(
        jax.random.PRNGKey(0), x0, l0, None, l0, deterministic=True)
    back = generator_state_dict_from_jax(
        jax.tree.map(np.asarray, torch_interop.load_pth(g_path, template, "generator")))
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    cfg.mode = "test"
    paths = run_test(cfg)  # no optimize checkpoint: the warmup G
    assert len(paths) == 4 and all(os.path.exists(p) for p in paths)


def test_run_warmup_saves_when_validation_never_improves(tiny_corpus, tmp_path, monkeypatch):
    """A NaN validation loss never improves: G.pth is still written at the
    end, and the patience of 1 stops after the second epoch."""
    make = warmup.make_warmup_steps

    def nan_eval(*args, **kw):
        train_step, eval_step = make(*args, **kw)
        return train_step, lambda batch, coins: eval_step(batch, coins) * float("nan")

    monkeypatch.setattr(warmup, "make_warmup_steps", nan_eval)
    cfg = _cfg(tiny_corpus, tmp_path, warmup_epochs=5)
    assert os.path.exists(warmup.run_warmup(cfg, progress=False))
    with open(os.path.join(cfg.log_dir, "tiny", "warmup", "events.jsonl")) as f:
        assert sum('"val_loss"' in line for line in f) == 2
