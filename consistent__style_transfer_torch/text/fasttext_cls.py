"""fasttext-style supervised text classifier: the port of the JAX package's
``text/fasttext_cls.py`` (its replacement for the C++ ``fasttext`` of the
reference's eval harness, ``evaluate/prepare.py:53``, ``evaluate/eval.py:32``).

fasttext's *default* supervised setup (``train_supervised`` with no extra
args, which the reference uses): bag-of-words averaged embeddings (dim=100),
linear softmax over labels, 5 epochs, lr 0.1 with linear decay, minCount=1,
wordNgrams=1, whitespace tokenization with an ``</s>`` EOS token per line.

The fit runs in PyTorch on ``device`` (the card, in the eval harness), where
the JAX package's runs as two jitted ``lax.scan`` programs on its device:
:func:`run_epoch` is fasttext's exact per-example SGD, one step a training
example; :func:`run_epoch_batched` applies B per-example gradients computed
on the batch-start parameters together, with the update's global norm
capped at ``clip * B``. Both sum repeated rows (a word twice in a sentence
gets both updates), as ``emb.at[rows].add`` does. An epoch runs in chunks
of ``GRAPH_CHUNK`` steps (examples, on the sequential path) through
:func:`~..train.graphs.step_runner`: on the card each chunk shape is one
CUDA graph, replayed (the JAX package's one dispatch an epoch, in a few
dozen), and the minibatch path adds the rows' updates by a product that
sums them in a fixed order (:func:`add_rows_by_product`), so a replay
equals an eager chunk bit for bit; on the CPU the chunks run eagerly, with
``index_add_``. ``predict`` and ``test`` run in numpy on the host, as in
the JAX package.

File format parity: train/test files are ``__label__<y>\\t<text>`` lines;
``predict(text, k)`` returns (labels, probs) with fasttext's ordering
(descending probability) and ``model.labels`` lists label strings. The
``.npz`` model (``emb``, ``out``, ``meta`` as JSON bytes) is the JAX
package's, so each package loads the other's.
"""

from __future__ import annotations

import json
import os
from collections import Counter

import numpy as np
import torch

from ..train.graphs import gc_paused, step_runner

EOS_WORD = "</s>"
# steps (minibatch path) or examples (sequential path) a chunk of an epoch:
# one CUDA graph replay on the card
GRAPH_CHUNK = 25


def _parse_line(line: str) -> tuple[str, str] | None:
    line = line.rstrip("\n")
    if not line:
        return None
    if "\t" in line:
        head, text = line.split("\t", 1)
    else:
        head, _, text = line.partition(" ")
    return head.strip(), text.strip()


def _parse_line_multi(line: str) -> tuple[set[str], str]:
    """Parse a fasttext line with any number of leading ``__label__`` tokens
    (tab- or space-separated), returning (gold label set, text)."""
    parts = line.rstrip("\n").replace("\t", " ").split(" ")
    golds: set[str] = set()
    i = 0
    while i < len(parts) and parts[i].startswith("__label__"):
        golds.add(parts[i])
        i += 1
    return golds, " ".join(parts[i:]).strip()


def _tokens(text: str) -> list[str]:
    return text.split() + [EOS_WORD]


def _lr(base_lr: float, t: torch.Tensor, total: int) -> torch.Tensor:
    """The linearly decayed rate at example count ``t`` (a device tensor)."""
    return base_lr * torch.clamp_min(1.0 - t / total, 1e-4)


def run_epoch(emb, out, ids, lens, ys, t, base_lr: float, total: int):
    """fasttext's sequential per-example SGD over the N examples of ``ids``,
    in place on ``emb`` (V+1, D) and ``out`` (D, C): hidden =
    mean(emb[words]); softmax CE; ``out`` and each input row get the raw
    per-example gradient (input rows scaled by 1/n_words), at the linearly
    decaying rate. ids (N, L) int64, lens (N,) float32 (>= 1), ys (N,) int64
    and t (a float32 scalar) on emb's device. Returns the advanced t. The
    rates of all N examples are computed up front from t + i (counts, exact
    in float32), the values the per-example recurrence gives. About 16
    device operations an example; no host synchronisation. Repeated rows of
    one example get equal updates, so ``index_add_`` gives the same sums in
    any order: on the card too the result does not depend on the order of
    its atomics."""
    N, L = ids.shape
    C = out.shape[1]
    masks = (torch.arange(L, device=ids.device)[None, :] < lens[:, None].long())[..., None]
    onehot = torch.nn.functional.one_hot(ys, C).to(out.dtype)
    lrs = _lr(base_lr, t + torch.arange(N, device=ids.device, dtype=t.dtype), total)
    for i in range(N):
        row, n, mask, lr = ids[i], lens[i], masks[i], lrs[i]
        hidden = torch.where(mask, emb[row], 0.0).sum(0) / n
        err = torch.softmax(hidden @ out, dim=-1) - onehot[i]  # dL/dlogits
        g_hidden = out @ err
        out.sub_(lr * torch.outer(hidden, err))
        emb.index_add_(0, row, torch.where(mask, -lr * g_hidden / n, 0.0))
    return t + N


def add_rows_in_order(emb, rows, mask, u) -> None:
    """emb[rows[b, l]] += u[b] where mask[b, l]: ``index_add_``, which on the
    CPU adds the (b, l) entries one after another, so a row repeated across
    the batch sums its updates in (b, l) order."""
    B, L = rows.shape
    upd = torch.where(mask, u[:, None, :], 0.0)
    emb.index_add_(0, rows.reshape(-1), upd.reshape(B * L, -1))


def add_rows_by_product(emb, rows, mask, u) -> None:
    """The same sum as :func:`add_rows_in_order` as one product: emb +=
    Aᵀ u, with A (B, V+1) the batch's row counts (A[b, w]: how often row w
    stands under sentence b's mask; counts, so their scatter is exact in any
    order). Deterministic on the card, where ``index_add_`` sums rows
    repeated across the batch with atomics in no fixed order; the sum's
    order differs from the CPU's, within float32 rounding."""
    A = torch.zeros((rows.shape[0], emb.shape[0]), dtype=emb.dtype, device=emb.device)
    A.scatter_add_(1, rows, mask[..., 0].to(emb.dtype))
    emb.addmm_(A.T, u)


def run_epoch_batched(emb, out, ids, lens, ys, valid, t, base_lr: float, total: int,
                      clip: float, add_rows=None):
    """The minibatch path over the S steps of ``ids``, in place: ids (S, B,
    L), lens, ys and valid (S, B). Each step computes B per-example
    gradients on the step-start parameters and applies them together, its
    global norm capped at ``clip * B`` (a per-example budget: healthy
    per-example norms are 0.1-0.5, so the cap binds only where B
    simultaneous full-rate updates would feed back and diverge); padded rows
    have valid = 0, so their error and their count in t are 0. The steps'
    rates come up front from t and the exclusive running sum of the valid
    counts (exact in float32), the values the per-step recurrence gives.
    ``add_rows``: how the input rows take their updates, by default
    :func:`add_rows_in_order` on the CPU and :func:`add_rows_by_product` on
    the card. Returns the advanced t. About 40 device operations a step; no
    host synchronisation."""
    S, B, L = ids.shape
    C = out.shape[1]
    if add_rows is None:
        add_rows = add_rows_by_product if emb.is_cuda else add_rows_in_order
    masks = (torch.arange(L, device=ids.device) < lens[..., None].long())[..., None]  # (S,B,L,1)
    onehot = torch.nn.functional.one_hot(ys, C).to(out.dtype)                         # (S, B, C)
    counts = valid.sum(1)
    lrs = _lr(base_lr, t + (torch.cumsum(counts, 0) - counts), total)
    for s in range(S):
        rows, ns, v, mask, lr = ids[s], lens[s], valid[s], masks[s], lrs[s]
        hidden = torch.where(mask, emb[rows], 0.0).sum(1) / ns[:, None]  # (B, D)
        p = torch.softmax(hidden @ out, dim=-1)                          # (B, C)
        err = (p - onehot[s]) * v[:, None]
        g_hidden = err @ out.T                                           # (B, D)
        g_out = hidden.T @ err                                           # (D, C)
        gnorm = torch.sqrt((g_out * g_out).sum() + (g_hidden * g_hidden).sum())
        step = lr * torch.clamp_max(clip * B / (gnorm + 1e-12), 1.0)
        out.sub_(step * g_out)
        add_rows(emb, rows, mask, -step * g_hidden / ns[:, None])
    return t + counts.sum()


class FastTextClassifier:
    """``sgd``: "sequential" replays fasttext's per-example SGD exactly (one
    step a training example: faithful, but N sequential steps an epoch);
    "minibatch" applies ``batch_size`` per-example gradients computed on the
    same (stale-within-batch) parameters, the synchronous analogue of
    fasttext's hogwild threads, ~batch_size x fewer steps; "auto" (default)
    picks minibatch above 20,000 examples, as the JAX package does.

    B per-example gradients land at the full rate in one step (hogwild
    semantics, not a mean), so each step caps the update's global norm at
    ``clip * B``. ``fit`` checks after each epoch that the tables are finite
    and bails out of a diverged attempt; a diverged minibatch fit retries at
    B/4, then B/16, printing each retry. The SGD path and batch size of the
    fit are recorded in ``fit_meta`` and saved with the model.

    ``device``: where ``fit`` runs (the card unless the caller asks for the
    CPU; no fallback). The fitted tables come back to the host as numpy."""

    def __init__(self, dim: int = 100, lr: float = 0.1, epochs: int = 5,
                 min_count: int = 1, batch_size: int = 64, seed: int = 0,
                 max_len: int = 64, sgd: str = "auto", clip: float = 1.0,
                 device: str | torch.device = "cuda"):
        self.sgd = sgd
        self.dim = dim
        self.lr = lr
        self.epochs = epochs
        self.min_count = min_count
        self.batch_size = batch_size
        self.seed = seed
        self.max_len = max_len
        self.clip = clip
        self.device = torch.device(device)
        self.vocab: dict[str, int] = {}
        self.labels: list[str] = []
        self.emb: np.ndarray | None = None   # (V+1, D); row 0 = pad
        self.out: np.ndarray | None = None   # (D, n_labels)
        self.fit_meta: dict = {}             # sgd path / batch size provenance

    # ------------------------------------------------------------------ train
    def fit_file(self, path: str) -> "FastTextClassifier":
        labels, texts = [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parsed = _parse_line(line)
                if parsed:
                    labels.append(parsed[0])
                    texts.append(parsed[1])
        return self.fit(texts, labels)

    def fit(self, texts, labels) -> "FastTextClassifier":
        counts = Counter(t for s in texts for t in _tokens(s))
        self.vocab = {
            w: i + 1
            for i, (w, _) in enumerate(
                sorted((wc for wc in counts.items() if wc[1] >= self.min_count),
                       key=lambda wc: (-wc[1], wc[0]))
            )
        }
        self.labels = sorted(set(labels))
        lab_idx = {l: i for i, l in enumerate(self.labels)}
        V, D, C = len(self.vocab), self.dim, len(self.labels)

        N = len(texts)
        ids = np.zeros((N, self.max_len), np.int64)
        lens = np.zeros(N, np.float32)
        y = np.array([lab_idx[l] for l in labels], np.int64)
        for i, s in enumerate(texts):
            toks = [self.vocab[t] for t in _tokens(s) if t in self.vocab][: self.max_len]
            ids[i, : len(toks)] = toks
            lens[i] = max(len(toks), 1)

        rng = np.random.default_rng(self.seed)
        emb0 = ((rng.random((V + 1, D)) - 0.5) / D).astype(np.float32)
        emb0[0] = 0
        dev = self.device
        ids_d, lens_d, y_d = (torch.from_numpy(a).to(dev) for a in (ids, lens, y))
        base_lr, total = self.lr, self.epochs * N
        use_batched = (self.sgd == "minibatch"
                       or (self.sgd == "auto" and N > 20_000))
        # the tables, allocated once a fit (an attempt starts from emb0 again)
        emb = torch.empty((V + 1, D), dtype=torch.float32, device=dev)
        out = torch.empty((D, C), dtype=torch.float32, device=dev)

        def epoch_part(x: dict, key):
            if use_batched:
                return run_epoch_batched(emb, out, x["ids"], x["lens"], x["ys"], x["valid"],
                                         x["t"], base_lr, total, self.clip)
            return run_epoch(emb, out, x["ids"], x["lens"], x["ys"], x["t"], base_lr, total)

        # an epoch as chunks of GRAPH_CHUNK steps (examples, on the sequential
        # path): on the card each chunk shape is one CUDA graph, replayed
        runner = step_runner(epoch_part, dev)

        def train_once(B: int):
            """One full training attempt; bails out (returning non-finite
            tables) at the first epoch whose tables went non-finite."""
            rng_e = np.random.default_rng(self.seed + 1)
            emb.copy_(torch.from_numpy(emb0))
            out.zero_()
            t = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(self.epochs):
                order = rng_e.permutation(N)
                if use_batched:
                    pad = (-N) % B
                    o = np.concatenate([order, np.zeros(pad, order.dtype)])
                    o = torch.from_numpy(o).to(dev)
                    valid = torch.cat([torch.ones(N, device=dev), torch.zeros(pad, device=dev)])
                    S = len(o) // B
                    x = {"ids": ids_d[o].reshape(S, B, self.max_len),
                         "lens": lens_d[o].reshape(S, B), "ys": y_d[o].reshape(S, B),
                         "valid": valid.reshape(S, B)}
                else:
                    o = torch.from_numpy(order).to(dev)
                    x = {"ids": ids_d[o], "lens": lens_d[o], "ys": y_d[o]}
                n = len(x["ids"])
                for a in range(0, n, GRAPH_CHUNK):
                    part = {k: v[a:a + GRAPH_CHUNK] for k, v in x.items()}
                    t = runner({**part, "t": t}, (B if use_batched else 1, len(part["ids"])))
                # one cheap reduction a epoch: any non-finite entry in
                # either table bails before the remaining epochs
                if use_batched and not torch.isfinite(out.sum() + emb.sum()):
                    break
            return emb.cpu().numpy(), out.cpu().numpy()

        # the divergence retry only makes sense for the minibatch path (the
        # sequential replay does not depend on B)
        B = self.batch_size
        attempts = [B, max(B // 4, 1), max(B // 16, 1)] if use_batched else [B]
        if use_batched:
            print(f"[fasttext] minibatch SGD: N={N} B={B} clip={self.clip} "
                  f"(sgd={self.sgd})", flush=True)
        for i, B in enumerate(attempts):
            if i > 0:
                print(f"[fasttext] non-finite fit at B={attempts[i - 1]}; "
                      f"retrying at B={B}", flush=True)
            emb_np, out_np = train_once(B)
            if np.isfinite(emb_np).all() and np.isfinite(out_np).all():
                break
        else:
            raise ValueError(
                f"fasttext SGD diverged (batch sizes tried: {attempts}); "
                + ("pass sgd='sequential'" if use_batched
                   else "inputs produce a non-finite sequential fit"))
        self.fit_meta = {
            "sgd_path": "minibatch" if use_batched else "sequential",
            "batch_size": int(B) if use_batched else 1,
            "retries": i if use_batched else 0,  # the loop index: attempts can
            # repeat a batch size (B <= 16 floors at 1)
            "clip": self.clip, "n_examples": N,
        }
        with gc_paused():  # the fit's graphs go here, at a known point
            del runner
        self.emb = emb_np
        self.emb[0] = 0
        self.out = out_np
        return self

    # ---------------------------------------------------------------- predict
    def _probs(self, text: str) -> np.ndarray:
        toks = [self.vocab[t] for t in _tokens(text) if t in self.vocab]
        if not toks:
            vec = np.zeros(self.dim, np.float32)
        else:
            vec = self.emb[toks].mean(0)
        logits = vec @ self.out
        e = np.exp(logits - logits.max())
        return e / e.sum()

    def predict(self, text: str, k: int = 1):
        """fasttext API: returns (labels tuple, probs array), descending."""
        probs = self._probs(text)
        order = np.argsort(-probs)[:k]
        return tuple(self.labels[i] for i in order), probs[order]

    def test(self, path: str) -> tuple[int, float, float]:
        """fasttext ``model.test``: (N, P@1, R@1) with fasttext's actual
        semantics — P@1 = correct predictions / N, R@1 = correct
        predictions / total gold labels. Lines may carry MULTIPLE leading
        ``__label__`` tokens (the fasttext file format allows it); the two
        numbers only coincide for single-label data."""
        n, correct, gold_total = 0, 0, 0
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                golds, text = _parse_line_multi(line)
                if not golds:
                    continue
                pred, _ = self.predict(text, k=1)
                n += 1
                gold_total += len(golds)
                correct += int(pred[0] in golds)
        return n, correct / max(n, 1), correct / max(gold_total, 1)

    # --------------------------------------------------------------------- io
    def save_model(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            emb=self.emb, out=self.out,
            meta=np.frombuffer(json.dumps({
                "vocab": self.vocab, "labels": self.labels, "dim": self.dim,
                "max_len": self.max_len, "fit_meta": self.fit_meta,
            }).encode(), dtype=np.uint8),
        )

    @classmethod
    def load_model(cls, path: str) -> "FastTextClassifier":
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            m = cls(dim=meta["dim"], max_len=meta.get("max_len", 64))
            m.fit_meta = meta.get("fit_meta", {})
            m.vocab = {k: int(v) for k, v in meta["vocab"].items()}
            m.labels = meta["labels"]
            m.emb = data["emb"]
            m.out = data["out"]
        return m
