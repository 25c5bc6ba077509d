"""Length-normalised beam search over fixed-length rollouts: the port of the
JAX package's ``models/beam.py``.

The corpus transfers are fixed-length (no EOS in decode, as in the
reference's test rollout), so a beam keeps ``beam_size`` prefixes a
sentence, extends each by every token, keeps the best ``beam_size`` sums of
log-probs over the K*V candidates (beam ``flat // V``, token ``flat % V``)
and, after ``max_len`` steps, returns the prefix whose sum over
``L ** length_penalty`` is highest.

:func:`beam_decode_any` picks the search by backbone: the LSTM takes the
stateful beam (``models/generator.py::stateful_beam_decode``: one encoder
pass, (h, c) carried a beam), the transformer the prefix rescoring of
:func:`beam_search`, one full teacher-forced pass through
``train.common.generator_call`` (``sched`` with a teacher) a step, the
encoder included, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable

import torch


def beam_search(next_logp_fn: Callable[[torch.Tensor, int, bool], torch.Tensor], B: int,
                L: int, V: int, beam_size: int = 4, length_penalty: float = 0.6,
                device=None):
    """``next_logp_fn(prefix (N, L) long, t, expanded)`` -> (N, V) float32
    log-probs of token t given ``prefix[:, :t]`` (the rest of the row is 0);
    ``expanded`` says whether N = B * beam_size or N = B (the step-0 call,
    on the un-expanded batch). Returns (ids (B, L) int32, scores (B,))."""
    K = beam_size
    logp0 = next_logp_fn(torch.zeros(B, L, dtype=torch.long, device=device), 0, False)
    scores, ids0 = logp0.topk(K, dim=-1)  # (B, K)
    prefixes = torch.zeros(B * K, L, dtype=torch.long, device=logp0.device)
    prefixes[:, 0] = ids0.reshape(-1)
    scores = scores.reshape(-1)
    for t in range(1, L):
        logp = next_logp_fn(prefixes, t, True)  # (B*K, V)
        scores, flat = (scores[:, None] + logp).reshape(B, K * V).topk(K, dim=-1)
        beam_idx, tok = flat // V, flat % V
        prefixes = prefixes.reshape(B, K, L).gather(1, beam_idx[:, :, None].expand(B, K, L))
        prefixes[:, :, t] = tok
        prefixes = prefixes.reshape(B * K, L)
        scores = scores.reshape(-1)
    return best_beam(prefixes, scores, B, K, L, length_penalty)


def best_beam(seqs: torch.Tensor, scores: torch.Tensor, B: int, K: int, L: int,
              length_penalty: float):
    """The best of each sentence's K beams by score / L ** length_penalty:
    (ids (B, L) int32, normalised scores (B,))."""
    norm = (scores / (L ** length_penalty)).reshape(B, K)
    best = norm.argmax(dim=1)
    rows = torch.arange(B, device=norm.device)
    return seqs.reshape(B, K, L)[rows, best].to(torch.int32), norm[rows, best]


@torch.inference_mode()
def beam_decode_any(model, x, label_i, tgt_label, beam_size: int = 4,
                    length_penalty: float = 0.6):
    """Beam decode of x (B, L) from style ``label_i`` to ``tgt_label`` for
    either backbone, without dropout: (ids (B, max_len) int32, scores
    (B,))."""
    from ..train.common import generator_call
    from .generator import DenoiseSeq2Seq, stateful_beam_decode

    if isinstance(model, DenoiseSeq2Seq):
        return stateful_beam_decode(model, x, label_i, tgt_label, beam_size, length_penalty)
    if model.training:
        raise ValueError("beam decode runs the model in eval mode (no dropout)")
    B, L, K = x.shape[0], model.max_len, beam_size
    x_rep, li_rep, tl_rep = (t.repeat_interleave(K, 0) for t in (x, label_i, tgt_label))

    def next_logp(prefix, t, expanded):
        args = (x_rep, li_rep, prefix, tl_rep) if expanded else (x, label_i, prefix, tgt_label)
        logits = generator_call(model, *args, mode="sched")
        return torch.log_softmax(logits[:, t].float(), dim=-1)

    return beam_search(next_logp, B, L, model.n_vocab, K, length_penalty, device=x.device)
