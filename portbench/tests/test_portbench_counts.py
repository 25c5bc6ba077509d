"""The yardstick's counts against hand counts at tiny shapes: the
Sinkhorn's least time, and the FLOP counts of the reference's work."""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT
from portbench.counts import flops
from portbench.counts.roofline import PEAK_BYTES_S, PEAK_OPS_S, PEAK_SFU_S, sinkhorn_bound


def test_sinkhorn_bound_by_hand():
    # two pairs of 2x3 valid atoms in 4x4, one empty pair
    got = sinkhorn_bound([2, 2, 0], [3, 3, 0], 4, 4)
    valid, atoms = 12, 10
    assert got["bytes"] == (3 * 4 + 3 * 4 + 3 * 16 + 3) * 4
    assert got["fma_flop"] == 2 * 2 * 100 * valid
    assert got["special_function_ops"] == 2 * 100 * atoms + 2 * valid + atoms
    want = max(got["bytes"] / PEAK_BYTES_S, got["fma_flop"] / PEAK_OPS_S["float32"],
               got["special_function_ops"] / PEAK_SFU_S) * 1e3
    assert got["bound_ms"] == pytest.approx(want)


def tiny_config(**kw):
    with open(os.path.join(ROOT, "portbench", "configs", "yelp.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg.update(vocab_size=7, batch_size=2, max_len=3,
               generator={"d_embed": 4, "d_enc": 3, "d_dec": 6, "p_drop": 0.1}, **kw)
    return cfg


def test_st_decode_flops_by_hand():
    """Per step of the straight-through decode: the decoder cell's two
    products, the attention's two batched products over the L memory
    positions, the head's two products, and the one-hot fed back through
    the embedding table; the encoder's cells in both directions; the
    transfer of the encoder cell."""
    import torch

    from portbench.reference import models as ref

    cfg = tiny_config()
    B, L, V, E, He, Hd = 2, 3, 7, 4, 3, 6
    enc = 2 * L * (2 * B * E * 4 * He + 2 * B * He * 4 * He)
    transfer = 2 * B * 2 * He * Hd
    step = (2 * B * E * 4 * Hd + 2 * B * Hd * 4 * Hd + 2 * (2 * B * L * 2 * He)
            + 2 * B * (Hd + 2 * He) * Hd + 2 * B * Hd * V + 2 * B * V * E)
    g = ref.build(cfg, "meta")["generator"].eval()
    x = torch.zeros(B, L, dtype=torch.long, device="meta")
    labels = torch.zeros(B, dtype=torch.long, device="meta")
    with torch.no_grad():
        got = flops._count(lambda: g(x, labels, None, 1 - labels, mode="st"))
    assert got == enc + transfer + L * step


def test_optimize_step_counts_forward_and_backward():
    """A step holds G's transfer forward and backward (the backward about
    twice the forward's products), the back-translation decode, and D's
    own transfer: more than four transfers' forward work."""
    import torch

    from portbench.reference import models as ref

    cfg = tiny_config()
    cfg["max_len"] = 6  # D's widest window is 5 tokens
    g = ref.build(cfg, "meta")["generator"]
    x = torch.zeros(2, 6, dtype=torch.long, device="meta")
    labels = torch.zeros(2, dtype=torch.long, device="meta")
    with torch.no_grad():
        transfer = flops._count(lambda: g(x, labels, None, 1 - labels, mode="st"))
    assert flops.optimize_step(cfg) > 4 * transfer > 0
