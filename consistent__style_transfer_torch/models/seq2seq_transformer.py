"""Transformer seq2seq generator, the second backbone (``--backbone
transformer``): the port of the JAX package's
``models/seq2seq_transformer.py``. T5-small widths (d=512, 8 heads, 6+6
layers, ff 2048), pre-LN with a final ``enc_norm`` / ``dec_norm``
(LayerNorm eps 1e-6, flax's default), learned positions (``MAX_POS`` 128),
style conditioning by adding the style embedding to every encoder-input and
decoder-input token embedding, a bias-free ``lm_head``.

- :meth:`TransformerSeq2Seq.forward` is the stages' call of a generator
  (:func:`batch_major_call`, the LSTM's signature): ``sched`` with a
  teacher is :meth:`~TransformerSeq2Seq.teacher_pass`, one parallel causal
  pass over the teacher shifted right behind the start embedding
  (``decode_teacher``), which draws no sched coins;
- :func:`generate` runs the autoregressive modes (``st``, ``sched`` without
  a teacher, ``greedy``) one KV-cached ``decode_step`` at a time. The JAX
  package writes each step's K/V into a preallocated (B, L, h, hd) cache and
  masks positions after t with -1e30; here each step's K/V is concatenated
  out of place and the step attends over positions 0..t, which is the same
  softmax (exp(-1e30 - max) is 0 in float32) and keeps every saved tensor
  intact for the backward of ``st``. Shapes are fixed for each t, so a CUDA
  graph can capture it. The cross-attention K/V of the memory are projected
  once per decode, where the JAX package projects them at every step.

Scores are divided by sqrt(float32(hd)) after the product; the causal mask
is -1e30, not -inf; the cross-attention has no mask, so PAD memory
positions are attended, as in the LSTM. Dropout acts on the embedded inputs
only (encoder input, teacher input, each decode step's input), its masks
drawn from an explicit ``torch.Generator``.

The JAX module computes in float32 whatever ``--dtype`` says (its ``dtype``
field reaches no submodule), so this one keeps float32 parameters and runs
its forward and :func:`generate` with autocast off, in training and in
serving alike. The attribute names follow the flax tree (``enc_0.attn.q``,
``dec_3.cross_attn.out``, ``dec_5.ln3``, ``lm_head``, ...), so
``utils/interop.py::transformer_generator_state_dict_from_jax`` maps each
weight by name. The widths are constructor arguments, for narrow test
models.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sampling import hard_sample_st
from . import initializers as init
from .transformer import dropout

D_MODEL = 512
N_HEADS = 8
N_ENC = 6
N_DEC = 6
D_FF = 2048
MAX_POS = 128
LN_EPS = 1e-6
MASK_VALUE = -1e30
GENERATE_MODES = ("st", "sched", "greedy")


def _float32(device: torch.device):
    """Autocast off: this backbone computes in float32 under any caller."""
    return torch.autocast(device.type, enabled=False)


class _Dense(nn.Linear):
    def reset_parameters_from(self, generator: torch.Generator) -> None:
        init.linear_kernel_(self.weight, generator)
        if self.bias is not None:
            init.linear_bias_(self.bias, self.in_features, generator)


class _MHA(nn.Module):
    """Multi-head attention with separate q/k/v/out projections."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q, self.k, self.v, self.out = (_Dense(d, d) for _ in range(4))

    def _heads(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.n_heads, -1)

    def project_kv(self, kv_in):
        """(k, v), each (B, Lk, h, hd)."""
        return self._heads(self.k(kv_in)), self._heads(self.v(kv_in))

    def attend(self, q_in, k, v, mask=None):
        q = self._heads(self.q(q_in))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        if mask is not None:
            scores = scores.masked_fill(~mask, MASK_VALUE)
        out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v)
        return self.out(out.reshape(out.shape[0], out.shape[1], -1))

    def forward(self, q_in, kv_in, mask=None):
        return self.attend(q_in, *self.project_kv(kv_in), mask=mask)


class _FFN(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.wi, self.wo = _Dense(d, d_ff), _Dense(d_ff, d)

    def forward(self, x):
        return self.wo(F.relu(self.wi(x)))


class _EncLayer(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1, self.ln2 = nn.LayerNorm(d, eps=LN_EPS), nn.LayerNorm(d, eps=LN_EPS)
        self.attn = _MHA(d, n_heads)
        self.ffn = _FFN(d, d_ff)

    def forward(self, x):
        h = self.ln1(x)
        x = x + self.attn(h, h)
        return x + self.ffn(self.ln2(x))


class _DecLayer(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1, self.ln2, self.ln3 = (nn.LayerNorm(d, eps=LN_EPS) for _ in range(3))
        self.self_attn = _MHA(d, n_heads)
        self.cross_attn = _MHA(d, n_heads)
        self.ffn = _FFN(d, d_ff)

    def forward(self, x, memory_kv, self_mask=None):
        """The parallel pass; ``memory_kv`` is the cross-attention's (k, v)."""
        h = self.ln1(x)
        x = x + self.self_attn(h, h, mask=self_mask)
        x = x + self.cross_attn.attend(self.ln2(x), *memory_kv)
        return x + self.ffn(self.ln3(x))

    def step(self, x, memory_kv, cache):
        """One cached step: x (B, 1, d); ``cache`` the (k, v) of the earlier
        steps or None. Returns (x, the cache grown by this step, out of
        place)."""
        h = self.ln1(x)
        k, v = self.self_attn.project_kv(h)
        if cache is not None:
            k, v = torch.cat([cache[0], k], dim=1), torch.cat([cache[1], v], dim=1)
        x = x + self.self_attn.attend(h, k, v)
        x = x + self.cross_attn.attend(self.ln2(x), *memory_kv)
        return x + self.ffn(self.ln3(x)), (k, v)


def batch_major_call(model, generate_fn, inp, label_i, x, label, mode: str, tau: float,
                     time_major_out: bool, generator: torch.Generator | None):
    """The stages' call of a generator that decodes batch-major (this
    backbone and LFM2-8B-A1B): ``sched`` with a teacher ``x`` is
    ``model.teacher_pass``, every other mode ``generate_fn`` over the
    teacher's length, or ``max_len`` without one. ``time_major_out`` on a
    soft output is a transpose; ids are batch-major."""
    if mode == "sched" and x is not None:
        out = model.teacher_pass(inp, label_i, x, label, generator)
    else:
        out = generate_fn(model, inp, label_i, label, mode=mode, tau=tau, generator=generator,
                          L_out=None if x is None else x.shape[1])
    return out.transpose(0, 1) if time_major_out and out.dim() == 3 else out


class TransformerSeq2Seq(nn.Module):
    time_major_soft = False  # its soft decode is (B, L, V)
    draws_sched_coins = False  # its teacher pass is parallel

    def __init__(self, n_vocab: int, n_class: int, max_len: int, p_drop: float = 0.1,
                 seed: int = 0, d_model: int = D_MODEL, n_heads: int = N_HEADS,
                 n_enc: int = N_ENC, n_dec: int = N_DEC, d_ff: int = D_FF,
                 max_pos: int = MAX_POS):
        super().__init__()
        self.n_vocab, self.max_len, self.p_drop = n_vocab, max_len, p_drop
        self.token_embedding = nn.Embedding(n_vocab, d_model)
        self.posit_embedding = nn.Embedding(max_pos, d_model)
        self.style_embedding = nn.Embedding(n_class, d_model)
        self.start_embedding = nn.Embedding(1, d_model)
        self.lm_head = nn.Linear(d_model, n_vocab, bias=False)
        for i in range(n_enc):
            self.add_module(f"enc_{i}", _EncLayer(d_model, n_heads, d_ff))
        for i in range(n_dec):
            self.add_module(f"dec_{i}", _DecLayer(d_model, n_heads, d_ff))
        self.enc_layers = [getattr(self, f"enc_{i}") for i in range(n_enc)]
        self.dec_layers = [getattr(self, f"dec_{i}") for i in range(n_dec)]
        self.enc_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's distributions: tokens and start N(0, 1),
        positions and style xavier uniform, every Dense U(+-1/sqrt(fan_in))
        for its kernel and bias, LayerNorm ones and zeros."""
        init.embedding_(self.token_embedding.weight, generator)
        init.embedding_(self.start_embedding.weight, generator)
        for emb in (self.posit_embedding, self.style_embedding):
            init.xavier_uniform_(emb.weight, *emb.weight.shape, generator)
        init.linear_kernel_(self.lm_head.weight, generator)
        for m in self.modules():
            if isinstance(m, _Dense):
                m.reset_parameters_from(generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    def _drop(self, t, generator):
        return dropout(t, self.p_drop, self.training, generator)

    def _embed_inp(self, inp):
        table = self.token_embedding.weight
        if torch.is_floating_point(inp):
            return hard_sample_st(inp.float()) @ table
        return F.embedding(inp.long(), table)

    def encode(self, inp, label_i, generator=None):
        """inp: ids (B, L) or soft (B, L, V) -> memory (B, L, d)."""
        e = self._embed_inp(inp)
        e = (e + self.posit_embedding.weight[: e.shape[1]]
             + self.style_embedding(label_i.long())[:, None, :])
        e = self._drop(e, generator)
        for layer in self.enc_layers:
            e = layer(e)
        return self.enc_norm(e)

    def bos(self, B: int, device) -> torch.Tensor:
        """The start embedding, (B, 1, d)."""
        return self.start_embedding(torch.zeros(B, 1, dtype=torch.long, device=device))

    def memory_kv(self, memory):
        """Each decoder layer's cross-attention (k, v) of ``memory``."""
        return [layer.cross_attn.project_kv(memory) for layer in self.dec_layers]

    def decode_teacher(self, memory, x, label, generator=None):
        """Parallel causal pass over x (B, L) shifted right behind the start
        embedding -> logits (B, L, V)."""
        B, L = x.shape
        tgt_in = torch.cat([self.bos(B, x.device), self.token_embedding(x[:, :-1].long())], 1)
        h = (tgt_in + self.posit_embedding.weight[:L]
             + self.style_embedding(label.long())[:, None, :])
        h = self._drop(h, generator)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        for layer, kv in zip(self.dec_layers, self.memory_kv(memory)):
            h = layer(h, kv, self_mask=causal)
        return self.lm_head(self.dec_norm(h))

    def decode_step(self, prev_emb, t: int, caches, memory_kv, label, generator=None):
        """One cached step: prev_emb (B, 1, d); ``caches`` one (k, v) or None
        per layer. Returns (logits (B, V), the new caches)."""
        h = prev_emb + self.posit_embedding.weight[t] + self.style_embedding(label)[:, None, :]
        h = self._drop(h, generator)
        new = []
        for layer, kv, cache in zip(self.dec_layers, memory_kv, caches):
            h, cache = layer.step(h, kv, cache)
            new.append(cache)
        return self.lm_head(self.dec_norm(h)[:, 0]), new

    def teacher_pass(self, inp, label_i, x, label, generator: torch.Generator | None = None):
        """The teacher-forced ``sched`` path: logits (B, L, V) of x (B, L)
        from ``inp`` (ids or soft) in style ``label_i``, to style ``label``."""
        with _float32(x.device):
            memory = self.encode(inp, label_i, generator)
            return self.decode_teacher(memory, x, label, generator)

    def forward(self, inp, label_i, x, label, mode: str = "sched", tau: float = 1.0,
                time_major_out: bool = False, generator: torch.Generator | None = None,
                coins: torch.Tensor | None = None):
        """Decode from ``inp`` in style ``label_i`` to style ``label``
        (:func:`batch_major_call`), with the signature of
        ``DenoiseSeq2Seq.forward``; ``coins`` is ignored."""
        return batch_major_call(self, generate, inp, label_i, x, label, mode, tau,
                                time_major_out, generator)

    def one_cast(self):
        """Nothing to share: this backbone computes in float32."""
        return contextlib.nullcontext()


def generate(model: TransformerSeq2Seq, inp, label_i, label, mode: str = "greedy",
             tau: float = 1.0, generator: torch.Generator | None = None,
             L_out: int | None = None):
    """Autoregressive decode over ``L_out`` (default ``max_len``) KV-cached
    steps. Returns probs softmax(logits / tau) (B, L, V) for ``st`` (the
    next input is the straight-through hard sample times the embedding
    table, so the gradient reaches both), logits (B, L, V) for ``sched``
    (greedy feedback: the x=None branch of the reference semantics), ids
    (B, L) int32 for ``greedy``. Dropout (in train mode) from
    ``generator``."""
    if mode not in GENERATE_MODES:
        raise ValueError(f"generate: mode must be one of {GENERATE_MODES}, got {mode!r}")
    L = model.max_len if L_out is None else L_out
    label = label.long()
    with _float32(inp.device):
        memory = model.encode(inp, label_i, generator)
        memory_kv = model.memory_kv(memory)
        table = model.token_embedding.weight
        x_t = model.bos(memory.shape[0], memory.device)
        caches = [None] * len(model.dec_layers)
        outs = []
        for t in range(L):
            logits_t, caches = model.decode_step(x_t, t, caches, memory_kv, label, generator)
            if mode == "st":
                out_t = torch.softmax(logits_t / tau, dim=-1)
                x_t = (hard_sample_st(out_t) @ table)[:, None, :]
            else:
                ids_t = logits_t.argmax(dim=-1)
                x_t = F.embedding(ids_t, table)[:, None, :]
                out_t = ids_t.to(torch.int32) if mode == "greedy" else logits_t
            outs.append(out_t)
        return torch.stack(outs, dim=1)
