"""The plain reference of the pretrain stage's WMD labels (``src/wmd.py``):
the entropy-regularised optimal-transport cost between the bags of the
two sentences' word2vec-known tokens.

Per pair: each side's masses are its unique known tokens (padding and
tokens without a vector left out), weighted by their counts and normalised;
the ground cost is the euclidean distance between the L2-normalised
vectors; the cost is <T, D> at the plan of ``iters`` log-domain Sinkhorn
updates (u, then v) at ``eps``. The reference's edge cases: a side with no
token takes the longer length; a side with no known token, the mean
length. Read from the tokenizer's vocabulary file and the word2vec file.
``dtype`` below float32 computes the solve in it (the control).
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import torch


class WmdLabels:
    def __init__(self, vocab_path: str, w2v_path: str, device, eps: float = 0.05,
                 iters: int = 100, dtype=torch.float32):
        self.vocab_path, self.w2v_path, self.dtype = vocab_path, w2v_path, dtype
        with open(vocab_path, encoding="utf-8") as f:
            token_of = {i: t for t, i in json.load(f).items()}
        data = np.load(w2v_path)
        rows = json.loads(bytes(data["meta"]).decode("utf-8"))["vocab"]
        self.row_of = {i: int(rows[t]) for i, t in token_of.items() if t in rows}
        vecs = torch.as_tensor(np.asarray(data["vectors"], np.float32), device=device)
        self.vecs = vecs / vecs.norm(dim=1, keepdim=True).clamp_min(1e-12)
        self.device, self.eps, self.iters = device, eps, iters

    def masses(self, ids) -> Counter:
        """{w2v row: count} of a sentence's known tokens (ids, PAD = 0)."""
        return Counter(self.row_of[i] for i in ids if i != 0 and i in self.row_of)

    def atoms(self, ids1, ids2) -> tuple[list[int], list[int]]:
        """The valid atoms of each side of each pair the Sinkhorn solves
        (0 for the pairs an edge case labels)."""
        n, m = [], []
        for a, b in zip(ids1, ids2):
            ma, mb = self.masses(a), self.masses(b)
            solved = bool(ma) and bool(mb)
            n.append(len(ma) if solved else 0)
            m.append(len(mb) if solved else 0)
        return n, m

    def labels(self, ids1, ids2) -> torch.Tensor:
        """(B,) float32 labels of the pairs of rows of ``ids1``, ``ids2``
        (integer arrays, right-padded with 0)."""
        ids1, ids2 = np.asarray(ids1).tolist(), np.asarray(ids2).tolist()
        out = torch.zeros(len(ids1))
        pairs = []
        for b, (a, c) in enumerate(zip(ids1, ids2)):
            la, lc = sum(t != 0 for t in a), sum(t != 0 for t in c)
            ma, mc = self.masses(a), self.masses(c)
            if la == 0 or lc == 0:
                out[b] = max(la, lc)
            elif not ma or not mc:
                out[b] = (la + lc) / 2
            else:
                pairs.append((b, ma, mc))
        if pairs:
            out[[b for b, _, _ in pairs]] = self._sinkhorn([p for _, p, _ in pairs],
                                                           [q for _, _, q in pairs]).cpu()
        return out

    def _sinkhorn(self, left: list[Counter], right: list[Counter]) -> torch.Tensor:
        B = len(left)
        N, M = max(map(len, left)), max(map(len, right))
        rows_p = torch.zeros(B, N, dtype=torch.long)
        rows_q = torch.zeros(B, M, dtype=torch.long)
        p, q = torch.zeros(B, N), torch.zeros(B, M)
        for b, (ma, mc) in enumerate(zip(left, right)):
            rows_p[b, :len(ma)] = torch.tensor(list(ma))
            p[b, :len(ma)] = torch.tensor(list(ma.values()), dtype=torch.float32)
            rows_q[b, :len(mc)] = torch.tensor(list(mc))
            q[b, :len(mc)] = torch.tensor(list(mc.values()), dtype=torch.float32)
        dev = self.device
        p, q = (p / p.sum(1, keepdim=True)).to(dev), (q / q.sum(1, keepdim=True)).to(dev)
        pm, qm = p > 0, q > 0
        mask = pm[:, :, None] & qm[:, None, :]
        va, vb = self.vecs[rows_p.to(dev)], self.vecs[rows_q.to(dev)]
        D = ((va[:, :, None, :] - vb[:, None, :, :]) ** 2).sum(-1).clamp_min(1e-12).sqrt()
        p, q, D = p.to(self.dtype), q.to(self.dtype), D.to(self.dtype)
        neg = torch.tensor(-1e30, device=dev, dtype=self.dtype)
        logK = torch.where(mask, -D / self.eps, neg)
        logp = torch.where(pm, p.clamp_min(1e-30).log(), neg)
        logq = torch.where(qm, q.clamp_min(1e-30).log(), neg)
        logu = torch.where(pm, 0.0, neg)
        logv = torch.where(qm, 0.0, neg)
        for _ in range(self.iters):
            logu = torch.where(pm, logp - torch.logsumexp(
                torch.where(mask, logK + logv[:, None, :], neg), dim=2), neg)
            logv = torch.where(qm, logq - torch.logsumexp(
                torch.where(mask, logK + logu[:, :, None], neg), dim=1), neg)
        T = torch.where(mask, torch.exp(logu[:, :, None] + logK + logv[:, None, :]), 0.0)
        return (T.float() * D.float()).sum(dim=(1, 2))
