"""The work of an optimize step with the LFM2-8B-A1B generator
(``configs/yelp-lfm2moe.json``), counted from the configuration, and the
least time of its expert products.

FlopCounterMode cannot count the generator on the meta device: which rows
each expert takes is data, and the plain reference runs each expert on its
own rows. Every token takes ``num_experts_per_tok`` experts, so the routed
work is fixed all the same: T x k rows through each expert layer, never T x
E. :func:`pass_flops` counts a pass of the generator as the equations do
(2 per multiply-add, products alone, as ``counts/flops.py`` counts the
other models), the test holding it to FlopCounterMode over the reference
on the CPU; the step adds the program's cached decode (one position a
step, attending to the positions so far), the backward (twice a forward's
products), and the scorers' and D's products, counted by FlopCounterMode
over the plain reference on the meta device.

:func:`gmm_bound_ms` is the least time of the grouped expert products of a
step (``moe_gemm_roofline``): each product's FLOPs at the bf16 peak or its
bytes at the HBM rate, whichever is longer, summed. A product reads all E
experts' weights (in a decode step each expert takes rows) and its rows,
and writes its result; a weight gradient writes E experts' worth.
"""

from __future__ import annotations

import torch

from portbench.counts.roofline import PEAK_BYTES_S, PEAK_OPS_S
from portbench.reference import lfm2_moe as ref_lfm2
from portbench.reference import models as ref

BF16 = 2  # bytes


def scorer_config(cfg: dict) -> dict:
    """``cfg`` with a stand-in for the LSTM generator that
    ``reference/models.py::build`` makes first: its widths enter no other
    module's shapes or draws."""
    return {**cfg, "generator": {"d_embed": 1, "d_enc": 1, "d_dec": 1, "p_drop": 0.0}}


def pass_flops(cfg: dict, rows: int, P: int, keys: int | None = None,
               head_positions: int | None = None) -> int:
    """One forward pass of ``rows`` sequences over P positions each,
    attending to ``keys`` positions (default P: a full causal pass), the
    head on ``head_positions`` of them (default P)."""
    w = ref_lfm2.widths(cfg)
    d, H, KV, hd = w["d"], w["H"], w["KV"], w["hd"]
    keys = P if keys is None else keys
    head_positions = P if head_positions is None else head_positions
    per_pos = 0
    for i, kind in enumerate(w["kinds"]):
        if kind == "conv":
            per_pos += 2 * d * 3 * d + 2 * d * d
        else:
            per_pos += 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d + 2 * 2 * H * hd * keys
        if i < w["n_dense"]:
            per_pos += 3 * 2 * d * w["ff"]
        else:
            per_pos += 2 * d * w["E"] + w["k"] * 3 * 2 * d * w["fe"]
    return rows * (P * per_pos + head_positions * 2 * d * cfg["vocab_size"])


def st_decode_flops(cfg: dict) -> int:
    """A straight-through decode forward: the source pass (L positions, no
    head), then L cached steps (one position, the positions so far as
    keys, the head) each feeding back the one-hot times the table."""
    B, L, V, d = cfg["batch_size"], cfg["max_len"], cfg["vocab_size"], cfg["hidden_size"]
    steps = sum(pass_flops(cfg, B, 1, keys=L + 1 + t) for t in range(L))
    return pass_flops(cfg, B, L, head_positions=0) + steps + L * 2 * B * V * d


def teacher_flops(cfg: dict) -> int:
    """The teacher-forced pass: 2L positions, the head on the last L."""
    B, L = cfg["batch_size"], cfg["max_len"]
    return pass_flops(cfg, B, 2 * L, head_positions=L)


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def scorer_step_flops(cfg: dict) -> int:
    """The step's products outside the generator: the classifier, the
    matcher and D on the soft transfer, back to it; D on the real and a
    fresh fake batch, back to its weights."""
    m = ref.build(scorer_config(cfg), "meta")
    for name in ("classifier", "matcher", "lm"):
        m[name].requires_grad_(False)
    B, L, V = cfg["batch_size"], cfg["max_len"], cfg["vocab_size"]
    x = torch.zeros(B, L, dtype=torch.long, device="meta")

    def step():
        # a product of the transfer (not a leaf: the flop counter's module
        # hooks refuse a leaf handed to autograd.grad)
        p = torch.zeros(B, L, V, device="meta", requires_grad=True) * 1.0
        out = m["classifier"](p).sum() + m["matcher"](p, x).sum() + m["disc"](p).sum()
        torch.autograd.grad(out, [p])
        fake = torch.zeros(B, L, V, device="meta")
        loss = m["disc"](x).sum() + m["disc"](fake).sum()
        torch.autograd.grad(loss, list(m["disc"].parameters()))

    return _count(step)


def optimize_step(cfg: dict) -> int:
    """One optimize step: G's decode and back-translation forward and
    backward, D's fresh decode forward, and the scorers' and D's products."""
    return 3 * (st_decode_flops(cfg) + teacher_flops(cfg)) + st_decode_flops(cfg) + \
        scorer_step_flops(cfg)


def validation_batch(cfg: dict) -> int:
    """One dev batch: the decode, then the classifier, the LM and the
    matcher on its ids."""
    m = ref.build(scorer_config(cfg), "meta")
    B, L = cfg["batch_size"], cfg["max_len"]
    x = torch.zeros(B, L, dtype=torch.long, device="meta")
    with torch.no_grad():
        scorers = _count(lambda: (m["classifier"](x), m["lm"](x), m["matcher"](x, x)))
    return st_decode_flops(cfg) + scorers


def _gmm_ms(flops: int, nbytes: int) -> float:
    return max(flops / PEAK_OPS_S["bfloat16"], nbytes / PEAK_BYTES_S) * 1e3


def gmm_bound_ms(cfg: dict) -> float:
    """Least ms of one optimize step's grouped expert products: per expert
    layer and call (the source pass and each cached step of G's decode and
    of D's, and the back-translation pass), the three products, and with
    gradients each one's two backward products (the rows' gradient, the
    experts' weight gradient)."""
    w = ref_lfm2.widths(cfg)
    B, L, k, E, d, fe = (cfg["batch_size"], cfg["max_len"], w["k"], w["E"], w["d"], w["fe"])
    n_moe = sum(1 for i in range(len(w["kinds"])) if i >= w["n_dense"])
    weights = E * d * fe * BF16

    def call(tokens: int, grad: bool) -> float:
        R = tokens * k
        # w1 and w3: (R, d) -> (R, fe); w2: (R, fe) -> (R, d): the same shape of work
        flops, rows_io = 2 * R * d * fe, R * (d + fe) * BF16
        fwd = 3 * _gmm_ms(flops, weights + rows_io)
        if not grad:
            return fwd
        d_rows = 3 * _gmm_ms(flops, weights + rows_io)  # dY (R, n) x W -> (R, m)
        d_weights = 3 * _gmm_ms(flops, rows_io + weights)  # X^T dY -> (E, m, n)
        return fwd + d_rows + d_weights

    decode = call(B * L, True) + L * call(B, True)
    d_decode = call(B * L, False) + L * call(B, False)
    return n_moe * (decode + call(B * 2 * L, True) + d_decode)
