"""The plain reference of the pretrain stage's first steps and its
validation losses (``src/main_pretrain.py:61-110``), in float32 with no
graphs, kernels or autocast: the classifier's CE on the style labels, the
matcher's MSE to the WMD labels on two noised variants, the LM's token CE
of the sentence from its shuffled variant, summed, one Adam over the three
towers behind a joint clip of the global norm. Dropout draws in the towers'
order, classifier, matcher, LM.

``fault="half_batch"`` plants the step that takes the mean over the first
half of the rows.
"""

from __future__ import annotations

import torch

from portbench.reference.optimize import Adam, cross_entropy

TOWERS = ("classifier", "matcher", "lm")


def losses(m: dict, batch: dict, generator, rows=None, fault: str | None = None):
    """(cls, mat, dn) losses of a batch {x, nx1, nx2, nx3, labels, wmd}."""
    if fault == "half_batch":
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    x = batch["x"]
    cls = cross_entropy(m["classifier"](x, generator), batch["labels"], mask=rows)
    err = (m["matcher"](batch["nx1"], batch["nx2"], generator).float() - batch["wmd"]) ** 2
    mat = err.mean() if rows is None else (err * rows).sum() / rows.sum().clamp_min(1.0)
    logits = m["lm"](batch["nx3"], generator)
    tok_rows = None if rows is None else rows[:, None].expand(x.shape).reshape(-1)
    dn = cross_entropy(logits.reshape(-1, logits.shape[-1]), x.reshape(-1), mask=tok_rows)
    return cls, mat, dn


def first_steps(m: dict, cfg: dict, batches, generator, fault: str | None = None):
    """The pretrain loop's first ``len(batches)`` steps, all three towers
    on. Returns {"losses": [(cls, mat, dn) per step], "grads": the first
    step's clipped gradient per leaf ("<tower>.<key>"), "params": every
    leaf after the last step}."""
    named = [(f"{t}.{k}", p) for t in TOWERS for k, p in m[t].named_parameters()]
    opt = Adam([p for _, p in named], cfg["pretrain"]["lr"], cfg["pretrain"]["clip"])
    out, first = [], {}
    for i, batch in enumerate(batches):
        for t in TOWERS:
            m[t].train()
        parts = losses(m, batch, generator, fault=fault)
        grads = opt.step(torch.autograd.grad(sum(parts), opt.params))
        if i == 0:
            first = {k: g for (k, _), g in zip(named, grads)}
        out.append(tuple(float(v.detach()) for v in parts))
    return {"losses": out, "grads": first,
            "params": {k: p.detach().clone() for k, p in named}}


@torch.no_grad()
def validation_losses(m: dict, dev_batches) -> list[float]:
    """Each tower's dev loss over the real rows, each batch weighted by its
    real rows. ``dev_batches``: (batch, row_mask)."""
    for t in TOWERS:
        m[t].eval()
    sums, weight = [0.0, 0.0, 0.0], 0.0
    for batch, rows in dev_batches:
        real = float(rows.sum())
        for i, v in enumerate(losses(m, batch, None, rows)):
            sums[i] += float(v) * real
        weight += real
    return [s / weight for s in sums]
