"""WMD regression labels for matcher pretraining: the port of the JAX
package's ``data/wmd_labels.py``.

The reference computes an exact per-pair Word-Mover's Distance with gensim on
the CPU inside the collate (``src/loader.py:60`` -> ``src/wmd.py:34-45``).
Two labelers:

- :class:`ExactWmdLabeler`: host-side exact OT, the parity path.
- :class:`SinkhornWmdLabeler`: one batched Sinkhorn solve per batch on the
  labeler's device: histograms over each pair's w2v-known tokens (numpy), the
  euclidean ground metric over L2-normalised vectors (torch), then the
  Sinkhorn kernel (``kernels/sinkhorn.py``; its plain version on the CPU),
  with the reference's edge cases (empty side -> max(len); no-vocab side ->
  mean(len)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.sinkhorn import sinkhorn_pallas
from ..utils.profiling import span


def _to_ragged(ids: np.ndarray, lens: np.ndarray) -> list[list[int]]:
    return [ids[i, : lens[i]].tolist() for i in range(len(lens))]


class ExactWmdLabeler:
    def __init__(self, w2v, tokenizer):
        self.w2v = w2v
        self.tokenizer = tokenizer

    def __call__(self, xs1, xs2):
        return self.w2v.cal_wmd_label(xs1, xs2, self.tokenizer)

    def label_pairs(self, ids1, lens1, ids2, lens2) -> np.ndarray:
        """Array-batch entry of the pipeline collate: (B,) float32 numpy."""
        return np.asarray(self.w2v.cal_wmd_label(_to_ragged(ids1, lens1),
                                                 _to_ragged(ids2, lens2), self.tokenizer),
                          dtype=np.float32)


def ot_inputs(vecs1, cnt1, vecs2, cnt2) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """vecs* (B, A, dim) gathered unique-token vectors; cnt* (B, A) counts
    (0 = padding atom) -> the Sinkhorn's (p, q, D): the JAX package's
    ``_sinkhorn_pairs`` up to the solve, with D computed as it computes it
    (not ``torch.cdist``, whose numbers differ)."""
    p = cnt1 / torch.clamp_min(cnt1.sum(dim=-1, keepdim=True), 1e-9)
    q = cnt2 / torch.clamp_min(cnt2.sum(dim=-1, keepdim=True), 1e-9)
    diff = vecs1[:, :, None, :] - vecs2[:, None, :, :]
    D = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=-1), 1e-12))
    return p.contiguous(), q.contiguous(), D.contiguous()


class SinkhornWmdLabeler:
    """Batched WMD labels on ``device``.

    Args:
      w2v: trained :class:`~..text.word2vec.Word2Vec` over BPE token strings
        (vectors are L2-normalised here, as ``init_sims(replace=True)`` in the
        reference ``src/wmd.py:54``).
      tokenizer: BPE tokenizer (id -> token strings).
      max_atoms: unique-token capacity per side (>= the noised length).
      device: where the vector table lives and the Sinkhorn runs.
    """

    def __init__(self, w2v, tokenizer, max_atoms: int = 48, epsilon: float = 0.05,
                 n_iters: int = 100, device: torch.device | str = "cpu"):
        self.max_atoms = max_atoms
        self.epsilon = epsilon
        self.n_iters = n_iters
        self.device = torch.device(device)
        V = len(tokenizer)
        # BPE id -> w2v row (+1, with 0 = OOV sentinel row of zeros)
        lut = np.zeros(V, dtype=np.int32)
        for bpe_id in range(V):
            tok = tokenizer.inv_vocab.get(bpe_id)
            row = w2v.vocab.get(tok, -1) if tok is not None else -1
            lut[bpe_id] = row + 1
        self.lut = lut
        vecs = np.asarray(w2v.vectors, dtype=np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-12)
        table = np.concatenate([np.zeros((1, vecs.shape[1]), np.float32), vecs], axis=0)
        self.table = torch.from_numpy(table).to(self.device)

    def _histograms(self, ids: np.ndarray, lens: np.ndarray):
        """Vectorised per-row unique-token histograms over w2v rows.

        ``ids`` (B, N) padded BPE ids, ``lens`` (B,). Returns (atom w2v rows
        (B, A) with 0 = padding atom, counts (B, A) float32). Sort each row
        (OOV/pad mapped to the 0 sink first), then run-length encode the runs."""
        B, N = ids.shape
        A = self.max_atoms
        rows = self.lut[ids]
        valid = np.arange(N)[None, :] < lens[:, None]
        srt = np.sort(np.where(valid, rows, 0), axis=1)
        first = np.ones((B, N), dtype=bool)
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        first &= srt > 0
        k = np.minimum(first.sum(axis=1), A)
        order = np.argsort(~first, axis=1, kind="stable")  # run starts first
        a = min(A, N)
        pos = order[:, :a].astype(np.int64)
        col = np.arange(a)[None, :]
        in_range = col < k[:, None]
        atom_ids = np.where(in_range, np.take_along_axis(srt, pos, axis=1), 0)
        nxt = np.where(col + 1 < k[:, None],
                       order[:, 1 : a + 1] if a < N
                       else np.concatenate([order[:, 1:], np.full((B, 1), N)], axis=1),
                       N)
        cnt = np.where(in_range, nxt - pos, 0).astype(np.float32)
        if a < A:
            atom_ids = np.pad(atom_ids, ((0, 0), (0, A - a)))
            cnt = np.pad(cnt, ((0, 0), (0, A - a)))
        return atom_ids.astype(np.int32), cnt

    def pair_inputs(self, ids1, lens1, ids2, lens2):
        """Padded id arrays and lengths of the two sides -> (p, q, D) on the
        labeler's device and the (B,) fallback labels (-1 where the Sinkhorn
        cost is the label)."""
        lens1 = np.asarray(lens1, np.int64)
        lens2 = np.asarray(lens2, np.int64)
        a1, c1 = self._histograms(np.asarray(ids1), lens1)
        a2, c2 = self._histograms(np.asarray(ids2), lens2)
        # reference edge cases (src/wmd.py:34-45): empty side -> max(len);
        # no-known-vocab side -> gensim inf -> mean(len)
        empty = (lens1 == 0) | (lens2 == 0)
        no_vocab = (c1.sum(axis=1) == 0) | (c2.sum(axis=1) == 0)
        fallback = np.where(
            empty, np.maximum(lens1, lens2).astype(np.float32),
            np.where(no_vocab, (lens1 + lens2).astype(np.float32) / 2, -1.0),
        ).astype(np.float32)
        # zero the histograms of fallback rows so the Sinkhorn sees benign
        # inputs (an all-zero pair costs 0)
        fb_row = (fallback >= 0)[:, None]
        a1 = np.where(fb_row, 0, a1)
        a2 = np.where(fb_row, 0, a2)
        c1 = np.where(fb_row, 0.0, c1).astype(np.float32)
        c2 = np.where(fb_row, 0.0, c2).astype(np.float32)

        def dev(a):  # pinned and asynchronous on CUDA: no wait for queued work
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

        p, q, D = ot_inputs(self.table[dev(a1).long()], dev(c1),
                            self.table[dev(a2).long()], dev(c2))
        return p, q, D, dev(fallback)

    def label_pairs(self, ids1, lens1, ids2, lens2) -> torch.Tensor:
        """Array-batch entry of the pipeline collate: (B,) float32 on the
        labeler's device, queued on the current stream and not waited for.
        When spans record, a ``data.wmd_label`` span holds its host time
        (histograms, ground cost, the Sinkhorn's launch)."""
        with span("data.wmd_label"):
            p, q, D, fallback = self.pair_inputs(ids1, lens1, ids2, lens2)
            cost = sinkhorn_pallas(p, q, D, epsilon=self.epsilon, n_iters=self.n_iters)
            return torch.where(fallback >= 0, fallback, cost)

    def __call__(self, xs1, xs2) -> torch.Tensor:
        """Ragged-list entry (tests, tools): aligns and defers to
        :meth:`label_pairs`."""
        n = max([len(x) for x in xs1 + xs2] + [1])
        B = len(xs1)
        ids1 = np.zeros((B, n), np.int32)
        ids2 = np.zeros((B, n), np.int32)
        l1 = np.array([len(x) for x in xs1], np.int64)
        l2 = np.array([len(x) for x in xs2], np.int64)
        for b in range(B):
            ids1[b, : l1[b]] = xs1[b]
            ids2[b, : l2[b]] = xs2[b]
        return self.label_pairs(ids1, l1, ids2, l2)
