"""Floating-point operations of the work a cell does, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on the
meta device at the configuration's shapes (no memory, no device). The count
is of the products and convolutions the equations need (2 per
multiply-add), forward and backward, so it stays the same whatever
implements the work. Counted per unit of work: an optimize step (G's update
and D's gradients; D's apply adds no product), a pretrain step, a
validation batch of either stage. The WMD labels'
Sinkhorn has no product; its kernel's bound is ``roofline.sinkhorn_bound``.
"""

from __future__ import annotations

import torch

from portbench.reference import models as ref
from portbench.reference import optimize as ref_opt
from portbench.reference import pretrain as ref_pre


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _inputs(cfg: dict):
    B, L = cfg["batch_size"], cfg["max_len"]
    return (torch.zeros(B, L, dtype=torch.long, device="meta"),
            torch.zeros(B, dtype=torch.long, device="meta"))


def optimize_step(cfg: dict) -> int:
    """One optimize step: G's loss forward and backward, then D's forward
    and backward on a fresh transfer."""
    m = ref.build(cfg, "meta")
    for name in ("classifier", "matcher", "lm"):
        m[name].requires_grad_(False)
    x, labels = _inputs(cfg)

    def step():
        total, _ = ref_opt.g_loss(m, cfg, x, labels, None)
        torch.autograd.grad(total, list(m["generator"].parameters()))
        loss = ref_opt.d_loss(m, cfg, x, labels, None)
        torch.autograd.grad(loss, list(m["disc"].parameters()))

    return _count(step)


def validation_batch(cfg: dict) -> int:
    """One dev batch of the optimize stage's validation."""
    m = ref.build(cfg, "meta")
    x, labels = _inputs(cfg)
    rows = torch.ones(cfg["batch_size"], device="meta")
    return _count(lambda: ref_opt.validation_terms(m, cfg, x, labels, rows))


def _pretrain_batch(cfg: dict):
    B, L = cfg["batch_size"], cfg["max_len"]
    noise_len = L + max(4, L // 2)  # the noised variants keep their insertions
    ids = lambda n: torch.zeros(B, n, dtype=torch.long, device="meta")  # noqa: E731
    return {"x": ids(L), "nx1": ids(noise_len), "nx2": ids(noise_len), "nx3": ids(L),
            "labels": torch.zeros(B, dtype=torch.long, device="meta"),
            "wmd": torch.zeros(B, device="meta")}


def pretrain_step(cfg: dict) -> int:
    """One pretrain step: the three towers' losses forward and backward."""
    m = ref.build(cfg, "meta")
    batch = _pretrain_batch(cfg)

    def step():
        parts = ref_pre.losses(m, batch, None)
        params = [p for t in ref_pre.TOWERS for p in m[t].parameters()]
        torch.autograd.grad(sum(parts), params)

    return _count(step)


def pretrain_eval_batch(cfg: dict) -> int:
    """One dev batch of the pretrain stage's validation."""
    m = ref.build(cfg, "meta")
    batch = _pretrain_batch(cfg)
    with torch.no_grad():
        return _count(lambda: ref_pre.losses(m, batch, None))

