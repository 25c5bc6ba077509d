"""The port's native text runtime (``text/native.py``, ``native/tpust.cc``
built into ``build/torch_native/``) on the CPU:

- ``NativeBPE`` encodes, batch-encodes and decodes as the port's Python
  ``BPETokenizer`` does, and ``native_bpe_train`` learns its vocab and
  merges; ``get_tokenizer`` returns the C++ tokenizer;
- ``native_w2v_train`` with one thread equals the JAX package's
  ``text/native.native_w2v_train`` bit for bit on the same ids and seed (the
  same source, flags and compiler), and so does the port's ``_native_w2v``
  path (its vocab building, then the trainer);
- two hogwild threads still learn the two-cluster corpus of
  tests/test_native.py;
- the content-preservation score (CP) of the eval harness with the hogwild
  trainer at its default threads stays within a stated bound of the
  one-thread trainer's, on the committed yelp corpus;
- a compiler that fails raises with its output: nothing falls back to the
  Python paths, which stay reachable by ``prefer_native=False``.
"""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.text import native as jax_native  # noqa: E402
from consistent__style_transfer_tpu.text.word2vec import Word2Vec as JaxWord2Vec  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.evaluate.content import (  # noqa: E402
    calculate_wmd_scores,
    mask_style_words,
    train_masked_word2vec,
)
from consistent__style_transfer_torch.evaluate.retokenize import tokenize  # noqa: E402
from consistent__style_transfer_torch.text import native  # noqa: E402
from consistent__style_transfer_torch.text.bpe import BPETokenizer, train_tokenizer  # noqa: E402
from consistent__style_transfer_torch.text.word2vec import train_sentences_w2v  # noqa: E402
from consistent__style_transfer_torch.train.common import get_tokenizer  # noqa: E402
from consistent__style_transfer_torch.utils.io import read_lines  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YELP = os.path.join(ROOT, "data", "yelp")
LINES = [
    "the food was terrible and cold .",
    "service was slow and rude , really !",
    "i ca n't believe how great this place is .",
    "best pizza i have ever had in my life .",
    "low lower lowest new newer newest wide wider widest",
] * 5
# the CP of the hogwild masked word2vec against the one-thread one, relative:
# measured up to 3.3% apart on this corpus (8 threads here, 100 + 100 pairs);
# hogwild races differ from run to run and host to host
CP_REL_TOL = 0.10
CP_LEXICON = {"good", "great", "bad", "terrible", "delicious", "rude", "friendly", "worst",
              "best", "amazing", "horrible", "love", "nice"}


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "train.0"
    path.write_text("\n".join(LINES) + "\n")
    return str(path)


def test_native_bpe_equals_python_bpe(corpus_file):
    tok = BPETokenizer.train([corpus_file], vocab_size=200)
    ntok = native.NativeBPE.from_python(tok)
    assert len(ntok) == len(tok)
    probes = LINES[:5] + ["unseen zebra words !", ""]
    for line in probes:
        assert ntok.encode(line) == tok.encode(line), line
        ids = tok.encode(line)
        assert ntok.decode(ids) == tok.decode(ids)
        assert ntok.ids_to_tokens(ids) == tok.ids_to_tokens(ids)
    ids, lens = ntok.encode_batch(probes, max_len=9)
    assert ids.shape == (len(probes), 9) and ids.dtype == np.int32
    for i, line in enumerate(probes):
        want = tok.encode(line)[:9]
        assert ids[i, : len(want)].tolist() == want and lens[i] == len(want)
        assert (ids[i, len(want):] == 0).all()


def test_native_bpe_train_equals_python_train(corpus_file):
    vocab, merges = native.native_bpe_train([corpus_file], vocab_size=120)
    py = BPETokenizer.train([corpus_file], vocab_size=120)
    assert vocab == py.vocab and merges == py.merges
    assert train_tokenizer([corpus_file], 120).vocab == py.vocab
    assert train_tokenizer([corpus_file], 120, prefer_native=False).merges == py.merges


def test_get_tokenizer_is_native_unless_asked(tiny_corpus, tmp_path):
    cfg = make_config("tiny", data_dir=os.path.dirname(tiny_corpus), dump_dir=str(tmp_path),
                      vocab_size=90, device="cpu")
    tok = get_tokenizer(cfg)
    py = get_tokenizer(cfg, prefer_native=False)
    assert isinstance(tok, native.NativeBPE) and isinstance(py, BPETokenizer)
    for line in read_lines(os.path.join(tiny_corpus, "style.dev.1")):
        assert tok.encode(line) == py.encode(line)


def _jax_library():
    if not (jax_native.available() or jax_native.build()):
        pytest.skip("the JAX package's native/libtpust.so does not build here")


def test_w2v_one_thread_equals_jax_native_bit_for_bit():
    _jax_library()
    rng = np.random.default_rng(0)
    sents = [list(rng.integers(0, 60, size=rng.integers(1, 14))) for _ in range(400)]
    sents.append([])  # an empty sentence is skipped on both sides
    kw = dict(dim=16, window=4, negative=3, epochs=3, seed=7, n_threads=1)
    got = native.native_w2v_train(sents, 60, **kw)
    want = jax_native.native_w2v_train(sents, 60, **kw)
    assert got.shape == (60, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_w2v_path_equals_jax_vocab_then_trainer():
    """The port's ``_native_w2v`` (the numpy trainer's vocab, the sentences
    as its ids) against the JAX package's vocab building and its library,
    one thread: the same vocab, the same vectors bit for bit."""
    _jax_library()
    sents = [tokenize(line) for line in read_lines(os.path.join(YELP, "style.dev.0"))]
    got = train_sentences_w2v(sents, epochs=2, seed=3, dim=20, n_threads=1)
    ref = JaxWord2Vec(None, dim=20, epochs=2, seed=3)
    ref._build_vocab(sents)
    encoded = [[ref.vocab[t] for t in s if t in ref.vocab] for s in sents]
    want = jax_native.native_w2v_train([e for e in encoded if e], vocab_size=len(ref.vocab),
                                       dim=20, epochs=2, seed=3, n_threads=1)
    assert got.vocab == ref.vocab and len(got.vocab) > 100
    np.testing.assert_array_equal(got.vectors, want)


def test_native_w2v_two_threads_learns_clusters():
    rng = np.random.default_rng(0)
    # two topic clusters over ids {0..3} and {4..7}
    sents = [list((0 if rng.random() < 0.5 else 4) + rng.integers(0, 4, size=8))
             for _ in range(600)]
    vecs = native.native_w2v_train(sents, vocab_size=8, dim=16, epochs=10, n_threads=2, seed=3)
    v = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    assert v[0] @ v[1] > v[0] @ v[5]


def test_hogwild_cp_within_bound_of_one_thread(tmp_path):
    """The eval harness's CP (mean WMD between masked pairs) with the masked
    word2vec trained on the yelp train split: default threads against one
    thread, within ``CP_REL_TOL`` (relative). chip_smoke.py phase 7 holds
    the card's host to the same bound."""
    texts = read_lines(os.path.join(YELP, "style.train.0")) + read_lines(
        os.path.join(YELP, "style.train.1"))
    masked = mask_style_words(texts, CP_LEXICON)
    origin = mask_style_words(read_lines(os.path.join(YELP, "style.test.0"))[:100]
                              + read_lines(os.path.join(YELP, "style.test.1"))[:100], CP_LEXICON)
    refs = mask_style_words(read_lines(os.path.join(YELP, "reference.0"))[:100]
                            + read_lines(os.path.join(YELP, "reference.1"))[:100], CP_LEXICON)
    cps = []
    for threads in (None, 1):
        w2v = train_masked_word2vec(masked, str(tmp_path / f"w{threads}.npz"), seed=0,
                                    n_threads=threads)
        w2v.init_sims()
        cps.append(float(np.mean(calculate_wmd_scores(refs, origin, w2v))))
    hogwild, single = cps
    assert np.isfinite(single) and single > 0
    assert abs(hogwild - single) <= CP_REL_TOL * single, (hogwild, single)


def test_broken_compiler_raises_and_does_not_fall_back(monkeypatch, tmp_path, tiny_corpus):
    broken = tmp_path / "g++"
    broken.write_text("#!/bin/sh\necho 'tpust.cc: error: no compiler here' >&2\nexit 1\n")
    broken.chmod(broken.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "compiler", lambda: str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no compiler here"):
            native.native_w2v_train([[0, 1, 2]], vocab_size=3, dim=4, epochs=1)
        with pytest.raises(RuntimeError, match="no compiler here"):
            train_sentences_w2v([["a", "b"]] * 10, epochs=1)
        cfg = make_config("tiny", data_dir=os.path.dirname(tiny_corpus),
                          dump_dir=str(tmp_path / "dump"), vocab_size=90, device="cpu")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            get_tokenizer(cfg)
        assert not os.path.exists(cfg.vocab_paths[0])  # nothing trained in Python instead
        assert not os.listdir(tmp_path / "build")
        # the Python paths, asked for by name
        assert isinstance(get_tokenizer(cfg, prefer_native=False), BPETokenizer)
        assert len(train_sentences_w2v([["a", "b"]] * 10, epochs=1, min_count=1,
                                       prefer_native=False).vocab) == 2
    finally:
        native.load.cache_clear()
