"""The stages' one-dispatch steps (``train/graphs.py``) as the CPU runs
them: eagerly, through the same loops that replay CUDA graphs on the card.

- Inference with a step that writes every batch's ids into one reused
  buffer and returns it, as a graph replay does: ``transfer_split`` must
  copy each batch's ids before the next step, so the ``.tsf`` files equal
  those of the plain step and the JAX package's, in float32. The id
  drains are deferred to the end of the split here, so a missing copy
  shows on every run, not only when a drain thread happens to be late.
- ``run_pretrain`` with the matcher frozen after its first epoch: the flag
  tuple changes and the later steps get no ``nx1``, ``nx2`` or ``wmd``.
- ``run_warmup`` and ``run_pretrain`` call their steps eagerly on the CPU
  (the parity of those steps with the JAX package's is held in
  tests/test_torch_warmup.py and tests/test_torch_pretrain.py).

The card's side (replays against eager steps) is
tests/test_torch_graph_steps_cuda.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.text import native as jax_native  # noqa: E402
from consistent__style_transfer_tpu.text.bpe import BPETokenizer as JaxBPE  # noqa: E402
from consistent__style_transfer_tpu.train import optimize as jax_optimize  # noqa: E402
from consistent__style_transfer_tpu.train.state import save_params  # noqa: E402
from consistent__style_transfer_tpu.utils.torch_interop import save_pth  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.train import graphs, infer, pretrain, warmup  # noqa: E402
from consistent__style_transfer_torch.train.common import (  # noqa: E402
    build_generator,
    get_tokenizer,
)
from consistent__style_transfer_torch.train.optimize import load_generator_params  # noqa: E402

MAX_LEN, BATCH, VOCAB = 10, 2, 150
SETTINGS = dict(max_len=MAX_LEN, batch_size=BATCH, vocab_size=VOCAB, dtype="float32")
SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)


@pytest.fixture(scope="module")
def workspace(tiny_corpus, tmp_path_factory):
    """One tokenizer dump and one JAX-initialised G_epoch_1, saved as
    .msgpack (JAX) and .pth (port)."""
    root = tmp_path_factory.mktemp("graph_steps")
    dirs = dict(data_dir=os.path.dirname(tiny_corpus), dump_dir=str(root / "dump"))
    cfg = make_config("tiny", out_dir=str(root / "out_torch"), device="cpu", mode="test",
                      **dirs, **SETTINGS)
    jcfg = jax_make_config("tiny", out_dir=str(root / "out_jax"), mode="test", **dirs, **SETTINGS)
    jcfg.mesh.n_data = 1
    tok = JaxBPE.train(cfg.train_files(), VOCAB)
    tok.save(cfg.ds_dump_dir, cfg.dataset)
    model = JaxSeq2Seq(n_vocab=len(tok), n_class=2, max_len=MAX_LEN)
    x0, l0 = jnp.zeros((2, MAX_LEN), jnp.int32), jnp.zeros((2,), jnp.int32)
    params = model.init(jax.random.PRNGKey(3), x0, l0, None, l0, deterministic=True)
    task = os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}")
    save_params(params, os.path.join(task, "G_epoch_1.msgpack"))
    save_pth(params, "generator", os.path.join(task, "G_epoch_1.pth"))
    return cfg, jcfg


class DeferredExecutor:
    """A ThreadPoolExecutor stand-in that runs each submitted drain only
    when its result is read, after the whole split was decoded."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        class Deferred:
            def result(self):
                return fn(*args)

        return Deferred()


def _reused_buffer_step(model):
    """The plain greedy step, its ids written into one buffer that every
    call overwrites and returns (what a CUDA graph's output buffer is)."""
    plain = infer.make_transfer_step(model)
    buf = {}

    def step(x, labels):
        ids = plain(x, labels)
        out = buf.setdefault("ids", torch.empty_like(ids))
        out.copy_(ids)
        return out

    return step


def _read(paths):
    return {os.path.basename(p): open(p, encoding="utf-8").read().splitlines() for p in paths}


def test_reused_output_buffer_gives_the_plain_and_jax_tsf(workspace, monkeypatch):
    cfg, jcfg = workspace
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "build", lambda quiet=True: False)
    theirs = _read(jax_optimize.run_test(jcfg))
    tokenizer = get_tokenizer(cfg)
    model = build_generator(cfg, len(tokenizer), torch.device("cpu"))
    load_generator_params(cfg, model)
    monkeypatch.setattr(infer, "ThreadPoolExecutor", DeferredExecutor)
    plain = _read(infer.run_inference(cfg, model, tokenizer))
    reused = _read(infer.run_inference(cfg, model, tokenizer, step_fn=_reused_buffer_step(model)))
    assert sorted(plain) == sorted(theirs) and len(plain) == 4
    assert reused == plain == theirs
    # 6 train lines a style at B=2: the train split is 6 batches, so a
    # missing copy would repeat the last batch's lines
    assert len(set(reused["style.train.0.tsf"] + reused["style.train.1.tsf"])) > 2


def test_transfer_split_copies_the_ids_of_every_batch(workspace, monkeypatch):
    """Without the copy, every deferred drain would read the last batch."""
    cfg, _ = workspace
    tokenizer = get_tokenizer(cfg)
    model = build_generator(cfg, len(tokenizer), torch.device("cpu"))
    load_generator_params(cfg, model)
    monkeypatch.setattr(infer, "ThreadPoolExecutor", DeferredExecutor)
    seen = []
    step = _reused_buffer_step(model)

    def recording(x, labels):
        out = step(x, labels)
        seen.append(out.clone())
        return out

    routed = infer.transfer_split(cfg, model, tokenizer, "train", step_fn=recording)
    assert len(seen) == 6
    want = {0: [], 1: []}
    labels = [0] * 6 + [1] * 6  # the corpus order of the train split
    for i, ids in enumerate(seen):
        for j in range(BATCH):
            want[labels[i * BATCH + j]].append(tokenizer.decode(ids[j].tolist()))
    assert routed == want


def test_step_runner_is_eager_on_the_cpu():
    calls = []

    def fn(inputs, key):
        calls.append((sorted(inputs), key))
        return inputs["a"] * 2

    run = graphs.step_runner(fn, torch.device("cpu"), (torch.Generator(),))
    assert not isinstance(run, graphs.GraphedStep)
    a = torch.arange(3)
    assert torch.equal(run({"a": a}, (True, False)), a * 2)
    assert torch.equal(run({"a": a}), a * 2)
    assert calls == [(["a"], (True, False)), (["a"], None)]


@pytest.mark.parametrize("flags, keys", [
    ((True, True, True), ("x", "labels", "nx1", "nx2", "wmd", "nx3")),
    ((True, False, True), ("x", "labels", "nx3")),
    ((False, True, False), ("nx1", "nx2", "wmd")),
    ((False, False, True), ("nx3", "x")),
])
def test_pretrain_step_inputs_follow_the_flags(flags, keys):
    assert pretrain.step_inputs(flags) == keys


def _record_runners(monkeypatch, module):
    """Wrap ``module.step_runner`` so every step call's input keys and
    branch key are recorded, and what the stage was given is kept."""
    calls, runners = [], []
    real = graphs.step_runner

    def recording(fn, device, *args, **kw):
        run = real(fn, device, *args, **kw)
        runners.append(run)

        def call(inputs, key=None):
            calls.append((tuple(sorted(inputs)), key))
            return run(inputs, key)

        return call

    monkeypatch.setattr(module, "step_runner", recording)
    return calls, runners


def test_pretrain_freeze_changes_the_flags_and_drops_the_matcher_inputs(tiny_corpus, tmp_path,
                                                                       monkeypatch):
    cfg = make_config("tiny", data_dir=os.path.dirname(tiny_corpus), dump_dir=str(tmp_path / "dump"),
                      log_dir=str(tmp_path / "log"), device="cpu", dtype="float32", max_len=8,
                      batch_size=4, vocab_size=120, epochs=3, **SCORER)
    calls, runners = _record_runners(monkeypatch, pretrain)
    # validation losses by epoch: the matcher's worsens after epoch 0 (so it
    # freezes), the others improve
    plan = iter([[3.0, 3.0, 3.0], [2.0, 1e9, 2.0], [1.0, 1.0]])
    real_validate = pretrain.validate

    def planned(batches, loss_fn, *args, **kw):
        got = real_validate(batches, loss_fn, *args, **kw)
        want = next(plan)
        assert len(got) == len(want)  # the active towers' losses
        return want

    monkeypatch.setattr(pretrain, "validate", planned)
    paths = pretrain.run_pretrain(cfg, progress=False)
    assert all(os.path.exists(p) for p in paths.values())
    assert len(runners) == 1 and not isinstance(runners[0], graphs.GraphedStep)
    steps = 12 // 4  # 12 train sentences, B=4, the partial batch dropped
    assert len(calls) == 3 * steps
    everything = tuple(sorted(("x", "labels", "nx1", "nx2", "wmd", "nx3")))
    assert calls[:2 * steps] == [(everything, (True, True, True))] * (2 * steps)
    assert calls[2 * steps:] == [(("labels", "nx3", "x"), (True, False, True))] * steps
    with open(os.path.join(cfg.log_dir, "tiny", "pretrain", "events.jsonl")) as f:
        epochs = [e for e in map(json.loads, f) if "train_steps" in e]
    assert [e["epoch"] for e in epochs] == [0, 1, 2]
    assert np.isnan(epochs[2]["val_mat"]) and all(np.isfinite(e["val_cls"]) for e in epochs)


def test_run_warmup_calls_its_step_eagerly_on_the_cpu(tiny_corpus, tmp_path, monkeypatch):
    cfg = make_config("tiny", data_dir=os.path.dirname(tiny_corpus), dump_dir=str(tmp_path / "dump"),
                      log_dir=str(tmp_path / "log"), device="cpu", dtype="float32", max_len=8,
                      batch_size=4, vocab_size=120, warmup_batch_size=4, warmup_epochs=2)
    calls, runners = _record_runners(monkeypatch, warmup)
    assert os.path.exists(warmup.run_warmup(cfg, progress=False))
    assert len(runners) == 1 and not isinstance(runners[0], graphs.GraphedStep)
    assert calls == [(("labels", "nx", "x"), None)] * (2 * 3)
