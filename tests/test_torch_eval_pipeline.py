"""The port's eval harness against the JAX package's, on the CPU, on the
synthetic styled corpus of tests/test_eval.py (with 20 + 20 reference
lines, so that ref-BLEU is scored):

- the masked word2vec equals the JAX package's numpy trainer's;
- ``run_eval`` on one set of artifacts made by the JAX ``run_prepare`` (the
  classifier, lexicon and masked word2vec shared as they are; the
  vectorizer and the adversarial LR carried across as numpy through
  ``utils/interop.py``) gives the JAX package's six numbers to 1e-9;
- the port's own ``run_prepare`` then ``run_eval`` lands within stated
  bounds of the JAX pipeline's numbers;
- ``human.py``, the all-ones EMDs and the line I/O equal the JAX package's.

The JAX package trains its masked word2vec natively whenever its library
loads, and so does the port; the tests turn that off on both sides
(``prefer_native=False`` in the port), so both run the numpy trainer. The
native trainers are held against each other in tests/test_torch_native.py."""

import csv
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from consistent__style_transfer_torch.evaluate import human as phuman
from consistent__style_transfer_torch.evaluate.content import (
    mask_style_words,
    train_masked_word2vec,
)
from consistent__style_transfer_torch.evaluate.prepare import eval_paths, run_prepare
from consistent__style_transfer_torch.evaluate.run_eval import run_eval
from consistent__style_transfer_torch.ops.emd import ones_metric_emd, pyemd_ones_emd
from consistent__style_transfer_torch.utils.interop import (
    l1_lr_from_arrays,
    vectorizer_from_vocabulary,
)
from consistent__style_transfer_torch.utils.io import read_lines, write_lines
from consistent__style_transfer_tpu.evaluate import content as jcontent
from consistent__style_transfer_tpu.evaluate import human as jhuman
from consistent__style_transfer_tpu.evaluate.prepare import eval_paths as jax_eval_paths
from consistent__style_transfer_tpu.evaluate.prepare import run_prepare as jax_run_prepare
from consistent__style_transfer_tpu.evaluate.run_eval import run_eval as jax_run_eval
from consistent__style_transfer_tpu.ops import emd as jemd
from consistent__style_transfer_tpu.text import native as jax_native
from consistent__style_transfer_tpu.utils import io as jio
from test_eval import styled_corpus  # noqa: F401  (the corpus recipe, as a fixture)

KEYS = ("STI", "CP", "NT", "ACC", "selfBLEU", "refBLEU")
SWAP = {"terrible": "wonderful", "awful": "amazing", "horrible": "fantastic",
        "disgusting": "delightful"}
SWAP.update({v: k for k, v in SWAP.items()})


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the cores
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def numpy_w2v_in_jax():
    """The JAX package's numpy word2vec trainer, not its native one."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "available", lambda: False)
    mp.setattr(jax_native, "build", lambda quiet=True: False)
    yield
    mp.undo()


def _transfer(line: str, i: int) -> str:
    """Swap the style words of two lines in three; drop the last token of
    every fifth: transfers that score neither perfectly nor at random."""
    toks = line.split()
    if i % 3:
        toks = [SWAP.get(t, t) for t in toks]
    if i % 5 == 0:
        toks = toks[:-1]
    return " ".join(toks)


@pytest.fixture(scope="module")
def eval_case(styled_corpus, tmp_path_factory, numpy_w2v_in_jax):  # noqa: F811
    """The corpus with references, the transfers as .tsf files, and the JAX
    package's artifacts and scores."""
    root = tmp_path_factory.mktemp("eval_case")
    data = root / "data"
    shutil.copytree(styled_corpus, data)
    out = root / "out"
    for split in ("train", "test"):
        for lab in (0, 1):
            lines = read_lines(f"{data}/style.{split}.{lab}")
            write_lines([_transfer(s, i) for i, s in enumerate(lines)],
                        f"{out}/style.{split}.{lab}.tsf")
    for lab in (0, 1):  # human references: the oracle swap
        write_lines([" ".join(SWAP.get(t, t) for t in s.split())
                     for s in read_lines(f"{data}/style.test.{lab}")], f"{data}/reference.{lab}")
    jax_dir = str(root / "jax_eval")
    state = np.random.get_state()
    np.random.seed(0)  # liblinear's coordinate order
    try:
        jax_run_prepare(str(data), str(out), jax_dir, "styled", ver="v0", quiet=True)
    finally:
        np.random.set_state(state)
    want = jax_run_eval(str(data), str(out), jax_dir, "styled", "v0", quiet=True)
    assert set(want) == set(KEYS)
    return {"root": root, "data": str(data), "out": str(out), "jax_dir": jax_dir, "want": want}


def test_masked_word2vec_equals_jax_numpy_trainer(styled_corpus, tmp_path,  # noqa: F811
                                                  numpy_w2v_in_jax):
    texts = (read_lines(f"{styled_corpus}/style.train.0")
             + read_lines(f"{styled_corpus}/style.dev.1"))
    masked = mask_style_words(texts, {"terrible", "amazing", "quite"})
    assert masked == jcontent.mask_style_words(texts, {"terrible", "amazing", "quite"})
    got = train_masked_word2vec(masked, str(tmp_path / "port.npz"), seed=3, prefer_native=False)
    want = jcontent.train_masked_word2vec(masked, str(tmp_path / "jax.npz"), seed=3)
    assert got.vocab == want.vocab and "MASK" in got.vocab
    np.testing.assert_array_equal(got.vectors, want.vectors)


def test_run_eval_equals_jax_on_carried_artifacts(eval_case):
    """The same artifacts (the vectorizer and adversarial LR carried across
    as numpy) and the same .tsf files: the six numbers to 1e-9."""
    jp = jax_eval_paths(eval_case["jax_dir"], "styled", "v0")
    port_dir = str(eval_case["root"] / "port_eval_carried")
    pp = eval_paths(port_dir, "styled", "v0")
    os.makedirs(os.path.dirname(pp["adv_model"]))
    for key in ("classifier", "lexicon", "mask_w2v"):  # shared formats
        shutil.copy(jp[key], pp[key])
    with open(jp["vectorizer"], "rb") as f:
        vectorizer_from_vocabulary(pickle.load(f).vocabulary_).save(pp["vectorizer"])
    with open(jp["adv_model"], "rb") as f:
        adv = pickle.load(f)
    l1_lr_from_arrays(adv.coef_, adv.intercept_, adv.classes_).save(pp["adv_model"])
    got = run_eval(eval_case["data"], eval_case["out"], port_dir, "styled", "v0", quiet=True)
    assert set(got) == set(KEYS)
    for key in KEYS:
        assert got[key] == pytest.approx(eval_case["want"][key], abs=1e-9), key


def test_run_prepare_then_eval_near_jax(eval_case, capsys):
    """The port's own artifacts (its classifier fit on the CPU, its
    newGLMNET lexicon and adversarial LR) against the JAX pipeline's
    numbers. The classifiers agree to 1e-5 and the lexicons exactly, so STI
    is held to 1e-6 (float32 probabilities), ACC and CP to 1e-9; the
    adversarial LRs are two fits of a degenerate problem, so NT is held to
    0.1 (4 of the 40 test pairs); the BLEUs read only the text. Measured:
    STI 0.65 in both (7.5e-10 apart), NT 0.5 in both."""
    port_dir = str(eval_case["root"] / "port_eval")
    paths = run_prepare(eval_case["data"], eval_case["out"], port_dir, "styled", ver="v0",
                        device="cpu", prefer_native=False)
    printed = capsys.readouterr().out
    assert "P@1" in printed and "[prepare] timings" in printed
    assert set(paths["timings"]) == {"classifier_s", "lexicon_s", "mask_s", "mask_w2v_s",
                                     "adv_lr_s"}
    assert all(os.path.exists(paths[k]) for k in ("classifier", "lexicon", "vectorizer",
                                                  "mask_w2v", "adv_model"))
    again = run_prepare(eval_case["data"], eval_case["out"], port_dir, "styled", ver="v0",
                        quiet=True, device="cpu", prefer_native=False)
    assert again["timings"] == {}  # idempotent: every artifact exists
    got = run_eval(eval_case["data"], eval_case["out"], port_dir, "styled", "v0", quiet=True)
    want = eval_case["want"]
    assert set(got) == set(KEYS)
    assert got["STI"] == pytest.approx(want["STI"], abs=1e-6)
    assert got["ACC"] == pytest.approx(want["ACC"], abs=1e-9)
    assert got["CP"] == pytest.approx(want["CP"], abs=1e-9)
    assert abs(got["NT"] - want["NT"]) <= 0.1
    assert got["selfBLEU"] == want["selfBLEU"] and got["refBLEU"] == want["refBLEU"]
    assert -1 <= got["STI"] <= 1 and 0 <= got["NT"] <= 1 and got["CP"] >= 0


def test_human_equals_jax(styled_corpus, tmp_path):  # noqa: F811
    out_dir = tmp_path / "sys"
    out_dir.mkdir()
    for lab in (0, 1):
        lines = read_lines(f"{styled_corpus}/style.test.{lab}")
        write_lines([_transfer(s, i) for i, s in enumerate(lines)],
                    f"{out_dir}/style.test.{lab}.tsf")
    for lab in (0, 1):  # system b copies its input
        shutil.copy(f"{styled_corpus}/style.test.{lab}", f"{tmp_path}/style.test.{lab}.tsf")
    systems = {"a": str(out_dir), "b": str(tmp_path)}
    for mod, name in ((phuman, "port.csv"), (jhuman, "jax.csv")):
        mod.sample_blind_csv(styled_corpus, systems, {"terrible", "amazing"}, str(tmp_path / name),
                             n_per_style=7, seed=5)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()

    rng = np.random.default_rng(0)
    raters = []
    for r in range(3):
        path = tmp_path / f"rater{r}.csv"
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["id", "STI", "CP", "NT"])
            w.writeheader()
            for i in range(12):
                w.writerow({"id": i, **{m: int(rng.integers(1, 4)) for m in ("STI", "CP", "NT")}})
        raters.append((str(path), r == 1))
    np.testing.assert_array_equal(phuman.ingest_rated_csv(raters[1][0], reverse=True),
                                  jhuman.ingest_rated_csv(raters[1][0], reverse=True))
    np.testing.assert_array_equal(phuman.score_rater_files(raters),
                                  jhuman.score_rater_files(raters))
    assert phuman.kappa_from_rater_files(raters) == jhuman.kappa_from_rater_files(raters)
    ranks = rng.integers(1, 4, size=(9, 3))
    systems = ["x", "y", "z"]
    assert phuman.score_ratings(ranks, systems) == jhuman.score_ratings(ranks, systems)
    human, metric = rng.normal(size=30), rng.normal(size=30)
    assert (phuman.correlate_with_human({"m": metric}, human)
            == jhuman.correlate_with_human({"m": metric}, human))


def test_ones_emd_and_line_io_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    p, q = rng.random((4, 3, 2)), rng.random((4, 3, 2))
    for port_fn, jax_fn in ((pyemd_ones_emd, jemd.pyemd_ones_emd),
                            (ones_metric_emd, jemd.ones_metric_emd)):
        got = port_fn(torch.from_numpy(p).float(), torch.from_numpy(q).float())
        assert got.shape == (4, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(p, q)), rtol=1e-6, atol=1e-7)
    lines = ["a b \n", "  c", ""]
    write_lines(lines, str(tmp_path / "port" / "x.txt"))
    jio.write_lines(lines, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port" / "x.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert read_lines(str(tmp_path / "jax.txt")) == jio.read_lines(str(tmp_path / "jax.txt"))
