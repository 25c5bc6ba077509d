"""The comparisons that decide ``correct``.

Training: norms compared leaf by leaf, by the worst leaf. A leaf's gap is
the distance between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger,
since some leaves' gradients are all but zero. Leaves whose first gradient
in the reference is under a thousandth of the median leaf's move under Adam
by round-off alone: the change leaves out the elements whose reference
gradient is under a thousandth of the median leaf's root-mean-square. An
embedding table's rows are also checked one by one: each row of an input
token that the reference moves has to move in the program.

Tokens: the widest gap by which a produced token's reference logit lies
below the reference's best logit at its step.
"""

from __future__ import annotations

import statistics

import torch

ROUNDOFF_SHARE = 1e-3


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """(the worst leaf's gap, its name) of the norms of ``prog`` against
    ``ref``."""
    pn, rn = norms(prog), norms(ref)
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving(ref_grads: dict) -> dict:
    """{leaf: mask} of the elements whose first gradient in the reference is
    not nought to rounding: at least a thousandth of the median leaf's
    root-mean-square gradient. A key's bias under softmax, part of the
    attention's input-projection bias, has a gradient of nought save for
    rounding, and moves under Adam by round-off alone; leaves with no such
    element are left out."""
    rms = {k: float(v.double().pow(2).mean().sqrt()) for k, v in ref_grads.items()}
    floor = ROUNDOFF_SHARE * statistics.median(rms.values())
    masks = {k: v.abs() >= floor for k, v in ref_grads.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def relative_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-12)


def training_gaps(losses, grads: dict, after: dict, ref: dict, init: dict) -> dict:
    """The numbers a training cell compares, of a run's first steps against
    the reference's (``ref``: {"losses", "grads", "params"}), both started
    from ``init``: ``loss_gap``, the largest relative gap of any step's
    loss; ``grad_gap``, the worst leaf's gap of the first step's gradient
    norms; ``change_gap``, the worst moving leaf's gap of the norms of the
    change over the steps. ``worst``: the leaves that set the last two."""
    ref_grads = {k: v.cpu() for k, v in ref["grads"].items()}
    keep = moving(ref_grads)
    loss_gap = max(relative_gap(p, r) for pl, rl in zip(losses, ref["losses"])
                   for p, r in zip(pl, rl))
    prog_grads = {k: v.cpu() for k, v in grads.items()}
    grad_gap, grad_leaf = worst_leaf_gap(prog_grads, ref_grads)
    change = {k: (after[k].cpu() - init[k])[m] for k, m in keep.items()}
    ref_change = {k: (ref["params"][k].cpu() - init[k])[m] for k, m in keep.items()}
    change_gap, change_leaf = worst_leaf_gap(change, ref_change)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "worst": {"grad_gap": grad_leaf, "change_gap": change_leaf}}


def rows_left_unmoved(after, ref_after, init, ids) -> int:
    """Rows of an embedding table, among those of the tokens ``ids`` that the
    reference moves, which the program leaves exactly where they were. A
    step whose loss leaves some of the batch's rows out gives the tokens
    only those rows hold no gradient, and Adam does not move them; in a
    sound step every token of the inputs has one."""
    ids = torch.unique(torch.as_tensor(ids).reshape(-1).long().cpu())
    moved_ref = (ref_after.cpu() - init)[ids].abs().amax(dim=-1) > 0
    moved = (after.cpu() - init)[ids].abs().amax(dim=-1) > 0
    return int((moved_ref & ~moved).sum())


def logit_gap(ref_logits, served) -> float:
    """Max over the tokens of (the reference's best logit at the step minus
    its logit of the served token); ``ref_logits`` (B, L, V), ``served``
    (B, L)."""
    ref_logits = ref_logits.float()
    picked = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return float((ref_logits.amax(dim=-1) - picked).max())
