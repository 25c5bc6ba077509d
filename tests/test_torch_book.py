"""The book dataset's shapes against the JAX package, on the CPU in float32
(``data/book``: the preset's L=30 and B=128, the WMD labeler's L + L // 2 =
45 atoms a side), on committed book lines: the pretrain collate with its
Sinkhorn labels, and greedy transfer on weights carried across by
``utils/interop.py``; then the port's CLI chain ``--dataset book`` (vocab,
w2v, pretrain, warmup, run) at tiny widths, whose ``eval`` prints no
ref-BLEU line, since book has no human references (the JAX package's
``evaluate/run_eval.py`` skips it so). One pretrain step and one fused
optimize step at L=30 are book cases of tests/test_torch_pretrain.py and
tests/test_torch_optimize_step.py.

Tolerances: noise arrays and greedy ids exact; WMD labels rtol 1e-4, atol
1e-4 (tests/test_torch_wmd_labels.py: D and the Sinkhorn summed in another
order), fallback rows exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.data import pipeline as jax_pipeline  # noqa: E402
from consistent__style_transfer_tpu.data import wmd_labels as jax_wmd  # noqa: E402
from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.text import word2vec as jax_w2v  # noqa: E402
from consistent__style_transfer_tpu.text.bpe import BPETokenizer as JaxBPE  # noqa: E402
from consistent__style_transfer_torch import cli  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data import pipeline  # noqa: E402
from consistent__style_transfer_torch.data import wmd_labels  # noqa: E402
from consistent__style_transfer_torch.data.corpus import StyleCorpus  # noqa: E402
from consistent__style_transfer_torch.models.generator import (  # noqa: E402
    DenoiseSeq2Seq,
    greedy_transfer,
)
from consistent__style_transfer_torch.text import word2vec  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.utils.interop import (  # noqa: E402
    generator_state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK = make_config("book")
L, B = BOOK.max_len, BOOK.batch_size
ATOMS = L + L // 2  # the labeler's capacity (train/pretrain.py)
LINES = 200  # committed book train lines a style


def _head(split, k, n):
    with open(os.path.join(ROOT, "data", "book", f"style.{split}.{k}"), encoding="utf-8") as f:
        return [next(f) for _ in range(n)]


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    """One BPE dump (vocab_size 600) read by both packages, a JAX word2vec
    (numpy trainer) saved as .npz and read by both, and the lines' ids at
    L=30, on the first LINES train lines of each book style."""
    root = tmp_path_factory.mktemp("book")
    files = []
    for k in (0, 1):
        files.append(str(root / f"style.train.{k}"))
        with open(files[-1], "w", encoding="utf-8") as f:
            f.writelines(_head("train", k, LINES))
    JaxBPE.train(files, 600).save(str(root), "book")
    paths = (str(root / "book-vocab.json"), str(root / "book-merges.txt"))
    jtok, tok = JaxBPE.load(*paths), BPETokenizer.load(*paths)
    jax_w2v.train_token_w2v(files, jtok, epochs=1, seed=4, prefer_native=False, dim=16,
                            min_count=1).save(str(root / "w2v.npz"))
    corpus = StyleCorpus.from_files(files, tok, L)
    return dict(jtok=jtok, tok=tok, w2v=str(root / "w2v.npz"), corpus=corpus)


def _normed(cls, path):
    w = cls.load(path)
    w.init_sims()
    return w


def test_pretrain_collate_at_45_atoms_matches_jax(book):
    """A batch of B=128 book sentences through both packages' pretrain
    collates, their Sinkhorn labelers at 45 atoms: the noise arrays equal,
    the labels within rtol 1e-4."""
    c = book["corpus"]
    rows = np.linspace(0, len(c) - 1, B).astype(int)  # both styles
    ids, lens, labels = c.ids[rows], c.lengths[rows], c.labels[rows]
    jl = jax_wmd.SinkhornWmdLabeler(_normed(jax_w2v.Word2Vec, book["w2v"]), book["jtok"],
                                    max_atoms=ATOMS)
    pl = wmd_labels.SinkhornWmdLabeler(_normed(word2vec.Word2Vec, book["w2v"]), book["tok"],
                                       max_atoms=ATOMS)
    want = jax_pipeline.collate_pretrain(L, jl)(ids, lens, labels, np.random.default_rng(13))
    got = pipeline.collate_pretrain(L, pl)(ids, lens, labels, np.random.default_rng(13))
    assert got["nx1"].shape == (B, L + max(4, L // 2)) == (B, ATOMS)
    for k in ("x", "nx1", "nx2", "nx3", "labels", "lengths"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    p, q, _, fallback = pl.pair_inputs(got["nx1"], (got["nx1"] > 0).sum(-1),
                                       got["nx2"], (got["nx2"] > 0).sum(-1))
    assert p.shape == (B, ATOMS) and int((p > 0).sum(-1).max()) > 16
    assert got["wmd"].dtype == torch.float32 and got["wmd"].shape == (B,)
    np.testing.assert_allclose(got["wmd"].numpy(), np.asarray(want["wmd"]), rtol=1e-4,
                               atol=1e-4)


def test_greedy_ids_at_book_shape_match_jax(book):
    """Float32 greedy transfer of B=128 book sentences at L=30 from one set
    of JAX weights (``generator_state_dict_from_jax``): the ids equal."""
    V = len(book["tok"])
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L)
    z = jnp.zeros((2, L), jnp.int32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), z, z[:, 0], None,
                                                 z[:, 0], deterministic=True))
    c = book["corpus"]
    rows = np.linspace(0, len(c) - 1, B).astype(int)
    x, labels = c.ids[rows], c.labels[rows]
    want = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(labels), None,
                                  jnp.asarray(1 - labels), mode="greedy", deterministic=True))
    port = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L)
    port.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    got = greedy_transfer(port.eval(), torch.from_numpy(x), torch.from_numpy(labels))
    assert got.shape == (B, L) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_book_cli_chain_evaluates_without_references(tmp_path, capsys):
    """vocab, w2v, pretrain, warmup and run (optimize, infer, eval-prepare,
    eval) through the port's CLI on the first committed book lines, at
    book's L=30 with tiny widths: eval prints its five scores, in range,
    and no ref-BLEU line; the results file neither."""
    data = tmp_path / "data" / "book"
    data.mkdir(parents=True)
    for split, n in (("train", 40), ("dev", 8), ("test", 8)):
        for k in (0, 1):
            (data / f"style.{split}.{k}").write_text("".join(_head(split, k, n)),
                                                     encoding="utf-8")
    assert not any(os.path.exists(os.path.join(ROOT, "data", "book", f"reference.{k}"))
                   for k in (0, 1))
    flags = ["--dataset", "book", "--data_dir", str(tmp_path / "data"),
             "--dump_dir", str(tmp_path / "dump"), "--log_dir", str(tmp_path / "log"),
             "--out_dir", str(tmp_path / "out"), "--device", "cpu", "--batch_size", "8",
             "--vocab_size", "150", "--scorer_layers", "1", "--scorer_d_model", "16",
             "--scorer_heads", "2", "--dtype", "float32", "--warmup_batch_size", "8",
             "--epochs", "1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the cores
    try:
        for command in ("vocab", "w2v", "pretrain", "warmup"):
            cli.main([command, *flags])
        capsys.readouterr()
        cli.main(["run", *flags])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    cfg = make_config("book", out_dir=str(tmp_path / "out"))
    assert cfg.max_len == 30
    scores = {}
    for label in ("STI (higher is better)", "CP (lower is better)", "NT (higher is better)",
                  "ACC (transfer accuracy)", "self-BLEU"):
        lines = [line for line in out.splitlines() if line.startswith(label + ": ")]
        assert len(lines) == 1, (label, out)
        scores[label] = float(lines[0].split(": ")[1])
    assert "ref-BLEU" not in out
    assert -1 <= scores["STI (higher is better)"] <= 1
    assert 0 <= scores["NT (higher is better)"] <= 1
    assert 0 <= scores["ACC (transfer accuracy)"] <= 1
    assert np.isfinite(scores["CP (lower is better)"]) and 0 <= scores["self-BLEU"] <= 100
    with open(os.path.join(cfg.out_dir, "book-v0.txt"), encoding="utf-8") as f:
        written = f.read()
    assert "STI" in written and "ref-BLEU" not in written
