"""The port's fastText classifier (``text/fasttext_cls.py``) against the JAX
package's, on the CPU in float32, on the synthetic styled corpus of
tests/test_eval.py and on the committed yelp split: both SGD paths fit the
same tables from the same seed, ``fit_meta`` is equal, each package loads
the other's ``.npz`` model, and ``test()`` gives the same (N, P@1, R@1)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from consistent__style_transfer_torch.text import fasttext_cls
from consistent__style_transfer_torch.text.fasttext_cls import FastTextClassifier
from consistent__style_transfer_tpu.text.fasttext_cls import FastTextClassifier as JaxFastText
from test_eval import styled_corpus  # noqa: F401  (the corpus recipe, as a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 SGD, the same arithmetic summed in another order: measured within
# 2e-7 of tables whose entries reach 0.8 (600 examples x 5 epochs), and
# within 1.9e-6 of entries up to 3.3 on the yelp split (2,500 steps of B=64)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the cores
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train_set(styled_corpus):  # noqa: F811
    labels, texts = [], []
    for lab in (0, 1):
        for line in open(f"{styled_corpus}/style.train.{lab}"):
            labels.append(f"__label__{lab}")
            texts.append(line.strip())
    return texts, labels


@pytest.mark.parametrize("kw", [{"sgd": "sequential"},
                                {"sgd": "minibatch", "batch_size": 16},
                                {"sgd": "minibatch", "batch_size": 64, "epochs": 8, "seed": 3}],
                         ids=["sequential", "minibatch_b16", "minibatch_b64_8ep"])
def test_fit_matches_jax(train_set, kw):
    texts, labels = train_set
    want = JaxFastText(**kw).fit(texts, labels)
    got = FastTextClassifier(device="cpu", **kw).fit(texts, labels)
    assert got.vocab == want.vocab and got.labels == want.labels
    assert got.fit_meta == want.fit_meta
    assert got.emb.dtype == np.float32 and got.emb.shape == want.emb.shape
    np.testing.assert_allclose(got.emb, want.emb, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.out, want.out, rtol=0, atol=ATOL)
    assert not got.emb[0].any()
    for text in texts[::37]:
        assert got.predict(text, k=2)[0] == want.predict(text, k=2)[0]


def test_auto_picks_minibatch_above_20000():
    """sgd="auto": minibatch above 20,000 examples, sequential at or below."""
    rng = np.random.default_rng(0)
    texts = [f"w{rng.integers(50)} w{rng.integers(50)}" for _ in range(20_001)]
    labels = [f"__label__{int(t.split()[0][1:]) % 2}" for t in texts]
    big = FastTextClassifier(device="cpu", epochs=1).fit(texts, labels)
    assert big.fit_meta == {"sgd_path": "minibatch", "batch_size": 64, "retries": 0,
                            "clip": 1.0, "n_examples": 20_001}
    small = FastTextClassifier(device="cpu", epochs=1).fit(texts[:300], labels[:300])
    assert small.fit_meta["sgd_path"] == "sequential" and small.fit_meta["batch_size"] == 1


def test_diverged_minibatch_retries_then_raises(train_set, capsys):
    """A fit whose tables go non-finite (here from a NaN rate) retries at
    B/4 and B/16, printing each retry as the JAX package does, then
    raises."""
    texts, labels = train_set
    for cls, kw in ((JaxFastText, {}), (FastTextClassifier, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"batch sizes tried: \[64, 16, 4\]"):
            cls(sgd="minibatch", lr=float("nan"), epochs=2, **kw).fit(texts, labels)
        out = capsys.readouterr().out
        assert "retrying at B=16" in out and "retrying at B=4" in out


def test_models_load_in_both_directions(train_set, tmp_path):
    texts, labels = train_set
    port = FastTextClassifier(device="cpu", sgd="minibatch", batch_size=16).fit(texts, labels)
    jax_model = JaxFastText(sgd="minibatch", batch_size=16).fit(texts, labels)
    port.save_model(str(tmp_path / "port.npz"))
    jax_model.save_model(str(tmp_path / "jax.npz"))
    in_jax = JaxFastText.load_model(str(tmp_path / "port.npz"))
    in_port = FastTextClassifier.load_model(str(tmp_path / "jax.npz"))
    assert in_jax.fit_meta == port.fit_meta and in_port.fit_meta == jax_model.fit_meta
    for text in texts[::11] + ["an unseen sentence"]:
        for a, b in ((in_jax, port), (in_port, jax_model)):
            la, pa = a.predict(text, k=2)
            lb, pb = b.predict(text, k=2)
            assert la == lb
            np.testing.assert_array_equal(pa, pb)


def test_test_gives_jax_counts_on_multilabel_lines(train_set, tmp_path):
    """(N, P@1, R@1) as the JAX package counts them, on single-label lines
    and on lines with two leading ``__label__`` tokens (R@1 = 0.5)."""
    texts, labels = train_set
    port = FastTextClassifier(device="cpu", epochs=2).fit(texts, labels)
    jax_model = JaxFastText.load_model(_saved(port, tmp_path))
    single = tmp_path / "single.txt"
    single.write_text("".join(f"{l}\t{t}\n" for l, t in zip(labels, texts)))
    multi = tmp_path / "multi.txt"
    multi.write_text("".join(f"__label__0 __label__1 {t}\n" for t in texts[:50]) + "\n")
    for path in (single, multi):
        assert port.test(str(path)) == jax_model.test(str(path))
    n, p, r = port.test(str(multi))
    assert n == 50 and p == 1.0 and r == pytest.approx(0.5, abs=1e-12)


def _saved(model, tmp_path) -> str:
    path = str(tmp_path / "model.npz")
    model.save_model(path)
    return path


def test_yelp_fit_matches_jax_and_holds_the_chip_floor(tmp_path):
    """On the committed yelp split (32,000 train sentences: sgd="auto" takes
    the minibatch path at B=64), the port's CPU fit equals the JAX
    package's, and the JAX fit's dev P@1 is the one that chip_smoke.py's
    phase-7 floor starts from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for split in ("train", "dev"):  # as evaluate/prepare.py writes them
        lines = [f"__label__{lab}\t{line.strip()}" for lab in (0, 1)
                 for line in open(os.path.join(ROOT, "data", "yelp", f"style.{split}.{lab}"))]
        (tmp_path / f"yelp.{split}").write_text("\n".join(lines) + "\n")
    want = JaxFastText(seed=0).fit_file(str(tmp_path / "yelp.train"))
    got = FastTextClassifier(seed=0, device="cpu").fit_file(str(tmp_path / "yelp.train"))
    assert got.fit_meta == want.fit_meta == {"sgd_path": "minibatch", "batch_size": 64,
                                             "retries": 0, "clip": 1.0, "n_examples": 32_000}
    np.testing.assert_allclose(got.emb, want.emb, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.out, want.out, rtol=0, atol=ATOL)
    n, p1, r1 = want.test(str(tmp_path / "yelp.dev"))
    assert n == 4_000 and p1 == r1 == pytest.approx(chip_smoke.EVAL_P1_JAX_CPU, abs=1e-12)
    assert got.test(str(tmp_path / "yelp.dev")) == (n, p1, r1)


def _reference_epoch(emb, out, ids, lens, ys, t, base_lr, total):
    """The sequential epoch as a per-example recurrence: the rate from t,
    then t + 1, an example at a time."""
    L, C = ids.shape[1], out.shape[1]
    masks = (torch.arange(L)[None, :] < lens[:, None].long())[..., None]
    onehot = torch.nn.functional.one_hot(ys, C).to(out.dtype)
    for i in range(ids.shape[0]):
        row, n, mask = ids[i], lens[i], masks[i]
        hidden = torch.where(mask, emb[row], 0.0).sum(0) / n
        err = torch.softmax(hidden @ out, dim=-1) - onehot[i]
        lr = fasttext_cls._lr(base_lr, t, total)
        g_hidden = out @ err
        out.sub_(lr * torch.outer(hidden, err))
        emb.index_add_(0, row, torch.where(mask, -lr * g_hidden / n, 0.0))
        t = t + 1.0
    return t


def _reference_epoch_batched(emb, out, ids, lens, ys, valid, t, base_lr, total, clip):
    """The minibatch epoch as a per-step recurrence: the rate from t, then
    t + the step's valid count; rows added with ``index_add_``."""
    S, B, L = ids.shape
    C = out.shape[1]
    ar = torch.arange(L)
    for s in range(S):
        rows, ns, v = ids[s], lens[s], valid[s]
        mask = (ar[None, :] < ns[:, None].long())[..., None]
        hidden = torch.where(mask, emb[rows], 0.0).sum(1) / ns[:, None]
        p = torch.softmax(hidden @ out, dim=-1)
        err = (p - torch.nn.functional.one_hot(ys[s], C).to(p.dtype)) * v[:, None]
        lr = fasttext_cls._lr(base_lr, t, total)
        g_hidden = err @ out.T
        g_out = hidden.T @ err
        gnorm = torch.sqrt((g_out * g_out).sum() + (g_hidden * g_hidden).sum())
        step = lr * torch.clamp_max(clip * B / (gnorm + 1e-12), 1.0)
        out.sub_(step * g_out)
        upd = torch.where(mask, (-step * g_hidden / ns[:, None])[:, None, :], 0.0)
        emb.index_add_(0, rows.reshape(-1), upd.reshape(B * L, -1))
        t = t + v.sum()
    return t


@pytest.mark.parametrize("path", ["sequential", "minibatch_in_order", "minibatch_by_product"])
def test_chunked_epochs_equal_the_per_step_recurrence(path):
    """Two epochs run as chunks (``fasttext_cls.GRAPH_CHUNK`` steps, t
    carried from chunk to chunk, the rates computed up front) against the
    per-step recurrence, on the CPU, from one seeded start: bit for bit
    where the rows are added in order; with the card's product update
    (:func:`add_rows_by_product`, the rows' sums in another order) within
    ATOL, float32 rounding over 2 x 26 steps. The padded last step (valid
    0) counts nothing in t."""
    rng = np.random.default_rng(7)
    V, D, C, L, N, B = 60, 16, 2, 9, 203, 8
    lens = rng.integers(1, L + 1, N).astype(np.float32)
    ids = np.where(np.arange(L) < lens[:, None], rng.integers(1, V + 1, (N, L)), 0)
    ys = rng.integers(0, C, N)
    emb0 = ((rng.random((V + 1, D)) - 0.5) / D).astype(np.float32)
    emb0[0] = 0
    total, K = 2 * N, fasttext_cls.GRAPH_CHUNK
    tables = []
    for chunked in (False, True):
        emb, out = torch.tensor(emb0), torch.zeros((D, C))
        t = torch.zeros(())
        for epoch in range(2):
            o = np.random.default_rng(epoch).permutation(N)
            x_ids, x_lens, x_ys = (torch.from_numpy(a[o]) for a in (ids, lens, ys))
            if path == "sequential":
                if not chunked:
                    t = _reference_epoch(emb, out, x_ids, x_lens, x_ys, t, 0.1, total)
                for a in range(0, N, K) if chunked else ():
                    t = fasttext_cls.run_epoch(emb, out, x_ids[a:a + K], x_lens[a:a + K],
                                               x_ys[a:a + K], t, 0.1, total)
                continue
            pad = (-N) % B
            S = (N + pad) // B
            x = [torch.cat([a, a[:pad]]).reshape(S, B, *a.shape[1:])
                 for a in (x_ids, x_lens, x_ys)]
            valid = torch.cat([torch.ones(N), torch.zeros(pad)]).reshape(S, B)
            if not chunked:
                t = _reference_epoch_batched(emb, out, *x, valid, t, 0.1, total, 1.0)
            add_rows = (fasttext_cls.add_rows_in_order if path == "minibatch_in_order"
                        else fasttext_cls.add_rows_by_product)
            for a in range(0, S, K) if chunked else ():
                t = fasttext_cls.run_epoch_batched(emb, out, *(v[a:a + K] for v in x),
                                                   valid[a:a + K], t, 0.1, total, 1.0,
                                                   add_rows=add_rows)
        tables.append((emb, out, t))
    (want_emb, want_out, want_t), (emb, out, t) = tables
    assert float(t) == float(want_t) == 2 * N
    if path == "minibatch_by_product":
        np.testing.assert_allclose(emb.numpy(), want_emb.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=0, atol=ATOL)
        assert not torch.equal(emb, want_emb)  # the product's order is another
    else:
        assert torch.equal(emb, want_emb) and torch.equal(out, want_out)
