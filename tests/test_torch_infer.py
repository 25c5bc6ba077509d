"""The slice as a whole against the JAX package, on the CPU in float32: one
tokenizer dump and one JAX-initialised generator, saved in both packages'
checkpoint formats into one dump layout; then the port's ``infer`` and
``serve`` and the JAX package's must give the same lines."""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu import cli as jax_cli  # noqa: E402
from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.text import native as jax_native  # noqa: E402
from consistent__style_transfer_tpu.text.bpe import BPETokenizer as JaxBPE  # noqa: E402
from consistent__style_transfer_tpu.train import optimize as jax_optimize  # noqa: E402
from consistent__style_transfer_tpu.train.state import save_params  # noqa: E402
from consistent__style_transfer_tpu.utils.torch_interop import save_pth  # noqa: E402
from consistent__style_transfer_torch import cli  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data.corpus import load_s2l  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.train.optimize import run_test  # noqa: E402

MAX_LEN, BATCH, VOCAB = 10, 4, 150
SETTINGS = dict(max_len=MAX_LEN, batch_size=BATCH, vocab_size=VOCAB, dtype="float32")


@pytest.fixture(scope="module")
def workspace(tiny_corpus, tmp_path_factory):
    """Dump layout shared by both packages: tokenizer, and G_epoch_1 as
    .msgpack (JAX) and .pth (port), both from one set of JAX params."""
    root = tmp_path_factory.mktemp("torch_infer")
    dirs = dict(data_dir=os.path.dirname(tiny_corpus), dump_dir=str(root / "dump"))
    cfg = make_config("tiny", out_dir=str(root / "out_torch"), device="cpu", **dirs, **SETTINGS)
    jcfg = jax_make_config("tiny", out_dir=str(root / "out_jax"), **dirs, **SETTINGS)
    jcfg.mesh.n_data = 1
    tok = JaxBPE.train(cfg.train_files(), VOCAB)
    tok.save(cfg.ds_dump_dir, cfg.dataset)
    model = JaxSeq2Seq(n_vocab=len(tok), n_class=2, max_len=MAX_LEN)
    x0 = jnp.zeros((2, MAX_LEN), jnp.int32)
    l0 = jnp.zeros((2,), jnp.int32)
    params = model.init(jax.random.PRNGKey(7), x0, l0, None, l0, deterministic=True)
    task = os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}")
    save_params(params, os.path.join(task, "G_epoch_1.msgpack"))
    save_pth(params, "generator", os.path.join(task, "G_epoch_1.pth"))
    return cfg, jcfg


@pytest.fixture
def python_tokenizer_only(monkeypatch):
    """Keep the JAX side on its pure-Python tokenizer (ids equal the native
    one's, tests/test_native.py) so this file never builds native/."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "build", lambda quiet=True: False)


def test_tokenizers_agree(tiny_corpus, tmp_path):
    files = [os.path.join(tiny_corpus, f"style.train.{i}") for i in (0, 1)]
    ours, theirs = BPETokenizer.train(files, VOCAB), JaxBPE.train(files, VOCAB)
    assert ours.vocab == theirs.vocab
    assert ours.merges == theirs.merges
    theirs.save(str(tmp_path), "tiny")  # the port reads the JAX package's dump
    loaded = BPETokenizer.load(str(tmp_path / "tiny-vocab.json"), str(tmp_path / "tiny-merges.txt"))
    for split in ("train", "dev", "test"):
        for i in (0, 1):
            path = os.path.join(tiny_corpus, f"style.{split}.{i}")
            pairs = load_s2l(path, ours.encode)
            assert [ids for ids, _ in pairs] == [theirs.encode(line) for line in
                                                 open(path).read().split("\n") if line.strip()]
            assert {label for _, label in pairs} == {i}
            for ids, _ in pairs:
                assert loaded.encode(ours.decode(ids)) == ids
                assert ours.decode(ids) == theirs.decode(ids)


def test_infer_tsf_matches_jax(workspace, python_tokenizer_only):
    cfg, jcfg = workspace
    cfg.mode = jcfg.mode = "test"
    ours = run_test(cfg)
    theirs = jax_optimize.run_test(jcfg)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert len(ours) == 4  # {train, test} x {0, 1}
    for a, b in zip(ours, theirs):
        lines = open(a, encoding="utf-8").read().splitlines()
        assert lines == open(b, encoding="utf-8").read().splitlines(), a
        split = os.path.basename(a).split(".")[1]
        assert len(lines) == {"train": 6, "test": 2}[split]


def _serve(main, argv, stdin_text, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


def test_serve_matches_jax(workspace, python_tokenizer_only, tiny_corpus, monkeypatch, capsys):
    cfg, jcfg = workspace
    lines = []
    for i in (0, 1):
        with open(os.path.join(tiny_corpus, f"style.dev.{i}"), encoding="utf-8") as f:
            lines += [f"{i}\t{line.strip()}" for line in f if line.strip()]
    lines.append("a line with no style prefix")  # 9 requests: two full batches + one
    stdin_text = "\n".join(lines) + "\n"
    flags = ["--dataset", "tiny", "--data_dir", cfg.data_dir, "--dump_dir", cfg.dump_dir,
             "--max_len", str(MAX_LEN), "--batch_size", str(BATCH), "--dtype", "float32"]
    ours = _serve(cli.main, ["serve", *flags, "--device", "cpu", "--out_dir", cfg.out_dir],
                  stdin_text, monkeypatch, capsys)
    monkeypatch.setattr(jax_cli, "config_from_args",
                        lambda argv: jcfg)  # the JAX CLI's config, single-device mesh
    theirs = _serve(jax_cli.main, ["serve"], stdin_text, monkeypatch, capsys)
    assert len(ours) == len(lines)
    assert ours == theirs
    assert not np.all([line == "" for line in ours])


def test_batches_match_jax(workspace):
    """Same corpus arrays and the same static-shape batches, with the last
    partial batch padded by index 0 and its ``valid`` count."""
    from consistent__style_transfer_tpu.data.corpus import StyleCorpus as JaxCorpus
    from consistent__style_transfer_tpu.data.pipeline import make_batches as jax_batches
    from consistent__style_transfer_torch.data.corpus import StyleCorpus
    from consistent__style_transfer_torch.data.pipeline import make_batches

    cfg, _ = workspace
    tok = BPETokenizer.load(*cfg.vocab_paths)
    files = cfg.split_files("train")
    ours, theirs = StyleCorpus.from_files(files, tok, MAX_LEN), JaxCorpus.from_files(files, tok, MAX_LEN)
    for field in ("ids", "lengths", "labels"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    a = list(make_batches(ours, 5, MAX_LEN, "optimize", shuffle=False))
    b = list(jax_batches(theirs, 5, MAX_LEN, "optimize", shuffle=False))
    assert [x.valid for x in a] == [x.valid for x in b] == [5, 5, 2]
    for x, y in zip(a, b):
        for key in ("x", "labels", "lengths"):
            np.testing.assert_array_equal(x[key], y[key])


def test_prefetcher_order_errors_and_early_exit():
    from consistent__style_transfer_torch.data.pipeline import Batch
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher

    batches = [Batch({"x": np.full((2, 3), i, np.int32)}, valid=2) for i in range(6)]
    got = [(b, t["x"]) for b, t in DevicePrefetcher(batches, "cpu")]
    assert [b for b, _ in got] == batches
    assert [int(t[0, 0]) for _, t in got] == list(range(6))

    for _, _ in DevicePrefetcher(batches, "cpu", depth=1):
        break  # the producer, blocked on a full queue, must still finish

    def failing():
        yield batches[0]
        raise ValueError("collate failed")

    with pytest.raises(ValueError, match="collate failed"):
        for _ in DevicePrefetcher(failing(), "cpu"):
            pass
