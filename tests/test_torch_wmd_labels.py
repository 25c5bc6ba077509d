"""WMD labels of the pretrain stage against the JAX package, on the CPU:
word2vec files and training, the histograms, both labelers (with the
reference's fallback rows), and the pretrain collate."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.data import pipeline as jax_pipeline  # noqa: E402
from consistent__style_transfer_tpu.data import wmd_labels as jax_wmd  # noqa: E402
from consistent__style_transfer_tpu.text import word2vec as jax_w2v  # noqa: E402
from consistent__style_transfer_tpu.text.bpe import BPETokenizer as JaxBPE  # noqa: E402
from consistent__style_transfer_torch.data import pipeline  # noqa: E402
from consistent__style_transfer_torch.data import wmd_labels  # noqa: E402
from consistent__style_transfer_torch.data.noise import align  # noqa: E402
from consistent__style_transfer_torch.text import word2vec  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402

W2V_KW = dict(dim=16, min_count=1)  # the tiny corpus has few tokens seen 5 times


@pytest.fixture(scope="module")
def setup(tiny_corpus, tmp_path_factory):
    """One BPE dump read by both packages' tokenizers, and a JAX word2vec
    (numpy trainer) saved as .npz."""
    root = tmp_path_factory.mktemp("wmd")
    files = [os.path.join(tiny_corpus, f"style.train.{i}") for i in (0, 1)]
    JaxBPE.train(files, 120).save(str(root), "tiny")
    paths = (str(root / "tiny-vocab.json"), str(root / "tiny-merges.txt"))
    jtok, tok = JaxBPE.load(*paths), BPETokenizer.load(*paths)
    jw = jax_w2v.train_token_w2v(files, jtok, epochs=3, seed=4, prefer_native=False, **W2V_KW)
    w2v_path = str(root / "tiny-w2v.npz")
    jw.save(w2v_path)
    dev = []
    for i in (0, 1):
        with open(os.path.join(tiny_corpus, f"style.dev.{i}")) as f:
            dev += [tok.encode(line.strip()) for line in f if line.strip()]
    return dict(files=files, jtok=jtok, tok=tok, jw=jw, w2v_path=w2v_path, dev=dev)


def _normed(w2v_cls, path):
    w = w2v_cls.load(path)
    w.init_sims()
    return w


def test_port_loads_the_jax_npz(setup):
    w = word2vec.Word2Vec.load(setup["w2v_path"])
    assert w.vocab == setup["jw"].vocab and w.dim == 16
    np.testing.assert_array_equal(w.vectors, setup["jw"].vectors)


def test_numpy_trainer_gives_the_same_vectors(setup):
    w = word2vec.train_token_w2v(setup["files"], setup["tok"], epochs=3, seed=4,
                                 prefer_native=False, **W2V_KW)
    assert w.vocab == setup["jw"].vocab
    np.testing.assert_array_equal(w.vectors, setup["jw"].vectors)


def test_save_load_roundtrip_is_read_by_jax(setup, tmp_path):
    w = word2vec.Word2Vec.load(setup["w2v_path"])
    path = str(tmp_path / "w.npz")
    w.save(path)
    back = jax_w2v.Word2Vec.load(path)
    assert back.vocab == w.vocab
    np.testing.assert_array_equal(back.vectors, w.vectors)


def _pairs(setup):
    """Dev sentences paired with their neighbours, plus the fallback rows:
    an empty side each way, both empty, and an all-UNK (no-vocab) side."""
    dev = setup["dev"]
    xs1 = [s[:12] for s in dev] + [[], dev[0], [], [3, 3, 3], dev[1]]
    xs2 = [s[::-1][:10] for s in dev[1:] + dev[:1]] + [dev[2], [], [], dev[3], [3, 3]]
    return xs1, xs2


def test_histograms_exact(setup):
    jw = _normed(jax_w2v.Word2Vec, setup["w2v_path"])
    w = _normed(word2vec.Word2Vec, setup["w2v_path"])
    jl = jax_wmd.SinkhornWmdLabeler(jw, setup["jtok"], max_atoms=15)
    pl = wmd_labels.SinkhornWmdLabeler(w, setup["tok"], max_atoms=15)
    np.testing.assert_array_equal(pl.lut, jl.lut)
    np.testing.assert_array_equal(pl.table.numpy(), np.asarray(jl.table))
    xs1, _ = _pairs(setup)
    ids, lens = align(xs1, 0, 14)
    for want, got in zip(jl._histograms(ids, lens.astype(np.int64)),
                         pl._histograms(ids, lens.astype(np.int64))):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)


def test_sinkhorn_labels_match_jax(setup):
    """Within 1e-4 (D and the Sinkhorn sum in another order); the fallback
    rows exactly."""
    jw = _normed(jax_w2v.Word2Vec, setup["w2v_path"])
    w = _normed(word2vec.Word2Vec, setup["w2v_path"])
    xs1, xs2 = _pairs(setup)
    want = np.asarray(jax_wmd.SinkhornWmdLabeler(jw, setup["jtok"], max_atoms=15)(xs1, xs2))
    got = wmd_labels.SinkhornWmdLabeler(w, setup["tok"], max_atoms=15)(xs1, xs2)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    n = len(setup["dev"])
    np.testing.assert_array_equal(got[n:], want[n:])
    dev = setup["dev"]  # empty side -> max(len); no-vocab side -> mean(len)
    assert got[n:].tolist() == [len(dev[2]), len(dev[0]), 0.0, (3 + len(dev[3])) / 2,
                                (len(dev[1]) + 2) / 2]


def test_exact_labels_equal_jax(setup):
    jw = _normed(jax_w2v.Word2Vec, setup["w2v_path"])
    w = _normed(word2vec.Word2Vec, setup["w2v_path"])
    xs1, xs2 = _pairs(setup)
    xs1, xs2 = xs1[:4] + xs1[-5:], xs2[:4] + xs2[-5:]
    ids1, l1 = align(xs1, 0, 14)
    ids2, l2 = align(xs2, 0, 14)
    want = np.asarray(jax_wmd.ExactWmdLabeler(jw, setup["jtok"]).label_pairs(ids1, l1, ids2, l2),
                      dtype=np.float32)
    got = wmd_labels.ExactWmdLabeler(w, setup["tok"]).label_pairs(ids1, l1, ids2, l2)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_len", [10, 30], ids=["tiny", "book"])
@pytest.mark.parametrize("gate", [None, False], ids=["matcher_on", "matcher_frozen"])
def test_collate_pretrain_matches_jax(setup, gate, max_len):
    """At a tiny width and at book's L=30, whose labeler takes L + L // 2 =
    45 atoms a side (train/pretrain.py)."""
    jw = _normed(jax_w2v.Word2Vec, setup["w2v_path"])
    w = _normed(word2vec.Word2Vec, setup["w2v_path"])
    atoms = max_len + max_len // 2
    need = None if gate is None else (lambda: gate)
    jfn = jax_pipeline.collate_pretrain(
        max_len, jax_wmd.SinkhornWmdLabeler(jw, setup["jtok"], max_atoms=atoms), need_matcher=need)
    fn = pipeline.collate_pretrain(
        max_len, wmd_labels.SinkhornWmdLabeler(w, setup["tok"], max_atoms=atoms),
        need_matcher=need)
    ids, lens = align(setup["dev"], 0, max_len)
    labels = np.arange(len(lens), dtype=np.int32) % 2
    want = jfn(ids, lens, labels, np.random.default_rng(11))
    got = fn(ids, lens, labels, np.random.default_rng(11))
    assert sorted(got) == sorted(want)
    assert got["nx1"].shape == (len(lens), max_len + max(4, max_len // 2))
    for k in ("x", "nx1", "nx2", "nx3", "labels", "lengths"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    wmd = got["wmd"].numpy() if isinstance(got["wmd"], torch.Tensor) else got["wmd"]
    np.testing.assert_allclose(wmd, np.asarray(want["wmd"]), rtol=1e-4, atol=1e-4)
    if gate is False:
        assert not got["nx1"].any() and not wmd.any()
