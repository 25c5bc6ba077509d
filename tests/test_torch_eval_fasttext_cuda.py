"""The fastText fit's epochs as CUDA graphs on the card
(``text/fasttext_cls.py``: an epoch in chunks of ``GRAPH_CHUNK`` steps or
examples, each chunk shape one ``train/graphs.py::GraphedStep`` graph)
against the same fit run eagerly on the card, on the committed yelp train
lines: the minibatch path, the sequential path and a fit whose first
attempt diverges (forced: the B=64 chunks start from a NaN count t, set
inside the graph) and whose retry at B/4 succeeds. Held bit for bit in float32:
both runs launch the same kernels on the same inputs, and the minibatch
path adds its rows by a product (``add_rows_by_product``) whose sums do not
depend on the order of atomics. Checked too: the replays per epoch (every
chunk a replay but the first call of each chunk shape) and the graphed fit
against a CPU fit, within chip_smoke.py's FASTTEXT_TABLE_TOL (1e-3: the
card's products sum in another order). Every test needs a CUDA device and
skips without one. This file imports no JAX, so it runs on a machine that
has only PyTorch (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_eval_fasttext_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.text import fasttext_cls  # noqa: E402
from consistent__style_transfer_torch.text.fasttext_cls import FastTextClassifier  # noqa: E402
from consistent__style_transfer_torch.train.graphs import GraphedStep  # noqa: E402

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_TOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _yelp(lines: int):
    texts, labels = [], []
    for lab in (0, 1):
        with open(os.path.join(ROOT, "data", "yelp", f"style.train.{lab}"), encoding="utf-8") as f:
            for line in list(f)[:lines]:
                texts.append(line.strip())
                labels.append(f"__label__{lab}")
    return texts, labels


def _fit(monkeypatch, graphed: bool, texts, labels, poison_b=None, **kw):
    """A fit on the card through graphs or eager chunks; returns the model,
    the runner (graphed: its GraphedStep) and the t each chunk returned.
    ``poison_b``: the chunks at that batch size start from a NaN count t
    (set inside the graph), so that attempt's tables go non-finite."""
    runners, ts = [], []

    def runner_for(fn, device):
        def step(x, key):
            if x["ids"].shape[1] == poison_b:
                x["t"].fill_(float("nan"))
            return fn(x, key)

        inner = GraphedStep(step) if graphed else (lambda x, key=None: step(x, key))
        runners.append(inner)

        def run(x, key=None):
            t = inner(x, key)
            ts.append(t.clone())
            return t
        return run

    monkeypatch.setattr(fasttext_cls, "step_runner", runner_for)
    model = FastTextClassifier(device="cuda", **kw).fit(texts, labels)
    return model, runners[0], ts


def _equal(a, b, ta, tb):
    assert a.fit_meta == b.fit_meta
    assert np.array_equal(a.emb, b.emb) and np.array_equal(a.out, b.out)
    assert len(ta) == len(tb)
    assert all(np.array_equal(x.cpu().numpy(), y.cpu().numpy(), equal_nan=True)
               for x, y in zip(ta, tb))


@pytest.mark.parametrize("path", ["minibatch", "sequential"])
def test_graphed_fit_equals_eager_fit(cuda_device, monkeypatch, path):
    """Bit for bit: tables, t after every chunk, fit_meta; each chunk a
    replay but the first call of its shape; the graphed fit within
    TABLE_TOL of a CPU fit."""
    texts, labels = _yelp(2000 if path == "minibatch" else 300)
    kw = dict(sgd=path, epochs=3, seed=1)
    graphed, runner, t_graphed = _fit(monkeypatch, True, texts, labels, **kw)
    eager, _, t_eager = _fit(monkeypatch, False, texts, labels, **kw)
    _equal(graphed, eager, t_graphed, t_eager)
    K = fasttext_cls.GRAPH_CHUNK
    steps = -(-len(texts) // 64) if path == "minibatch" else len(texts)
    chunks = -(-steps // K)
    B = 64 if path == "minibatch" else 1
    shapes = {(B, K), (B, steps % K)} - {(B, 0)}
    assert set(runner.graphs) == shapes
    assert runner.replays == 3 * chunks - len(shapes)
    assert float(t_graphed[-1]) == 3 * len(texts)
    monkeypatch.undo()
    cpu = FastTextClassifier(device="cpu", **kw).fit(texts, labels)
    assert cpu.fit_meta == graphed.fit_meta
    np.testing.assert_allclose(graphed.emb, cpu.emb, rtol=0, atol=TABLE_TOL)
    np.testing.assert_allclose(graphed.out, cpu.out, rtol=0, atol=TABLE_TOL)


def test_divergence_retry_graphed_equals_eager(cuda_device, monkeypatch, capsys):
    """The B=64 attempt goes non-finite (forced), the fit retries at B=16
    on new graphs from fresh tables, and the graphed fit equals the eager
    one bit for bit."""
    texts, labels = _yelp(1000)
    kw = dict(sgd="minibatch", epochs=2, seed=2)
    graphed, runner, t_graphed = _fit(monkeypatch, True, texts, labels, poison_b=64, **kw)
    eager, _, t_eager = _fit(monkeypatch, False, texts, labels, poison_b=64, **kw)
    assert "retrying at B=16" in capsys.readouterr().out
    assert graphed.fit_meta["batch_size"] == 16 and graphed.fit_meta["retries"] == 1
    assert np.isfinite(graphed.emb).all() and np.isfinite(graphed.out).all()
    _equal(graphed, eager, t_graphed, t_eager)
    assert {key[0] for key in runner.graphs} == {64, 16}
