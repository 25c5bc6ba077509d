"""LFM2-8B-A1B as the style-transfer generator, the third backbone
(``--backbone lfm2_moe``): a decoder-only hybrid of gated short
convolutions and grouped-query attention, with a dense SwiGLU FFN in its
first layers and a sparse mixture of 32 experts, top 4, in the others
(``models/moe.py``). Published configuration:
https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json; its
widths are :data:`PUBLISHED`, the defaults of :class:`Lfm2MoeGenerator`
(narrow test models pass others), and ``n_layers`` holds the first N of its
24 ``layer_types`` (``Config.lfm2_layers``).

A layer is ``h = h + mixer(RMSNorm(h))`` then ``h = h + ffn(RMSNorm(h))``;
after the last, an RMSNorm and a head tied to the token embedding (no
bias). RMSNorm is ``x * rsqrt(mean(x^2) + 1e-5) * w``, in float32.

- Conv mixer (``"conv"``): ``[b; c; x~] = in_proj(x)``, ``u = b * x~``,
  ``v_t = sum_j w_j * u_{t-2+j}`` (a depthwise causal convolution of width
  3, zeros before the sequence, no bias), ``out_proj(c * v)``. Its decode
  state is the last 2 ``u`` rows.
- Attention mixer (``"full_attention"``): q (32 x 64), k and v (8 x 64),
  no bias; an RMSNorm over the head dim on q and k; RoPE (theta 1e6,
  rotate-half); GQA, 4 query heads a KV head; a causal softmax of the
  scores over sqrt(64) (the masked scores -1e30); ``out_proj``. Its decode
  state is K and V, grown out of place a step (the transformer backbone's
  rule), so every saved tensor stays intact for the backward of ``st``.
- FFN: layers below ``n_dense`` (2) a SwiGLU ``w2(silu(w1 x) * w3 x)`` of
  width 7168; the others :class:`~.moe.SparseMoE`, 32 experts of width
  1792, top 4.

Style conditioning (this repository's, not LFM2's): the sequence is the
source (L tokens, each plus the embedding of style ``label_i``), then a
start embedding and the teacher or the generated tokens (each plus the
embedding of ``label``), causal throughout at positions 0..2L-1. Dropout
``p_drop`` acts on the embedded inputs only (the source block, then the
decoder side as a block in :meth:`forward` or one row a step in
:func:`generate`), its masks drawn from the explicit ``torch.Generator``.
:meth:`Lfm2MoeGenerator.forward` is the teacher-forced ``sched`` pass and
draws no sched coins; :func:`generate` runs ``st``, ``sched`` without a
teacher and ``greedy`` one cached step at a time, the shapes of each step
fixed, so a CUDA graph captures it. Beam search is
``models/beam.py::beam_decode_any``'s prefix rescoring.

Departures from the published model: ``expert_bias`` is held at zero and
never updated (no update rate is published) and there is no auxiliary
loss; the head is tied to the embedding (the configuration has no tying
key); the vocabulary is the system's BPE; weights are this port's draws
(embeddings N(0, 0.02^2), HF's default ``initializer_range``; every
product U(+-1/sqrt(fan_in)); the convolution U(+-1/sqrt(3)); norms 1).

Precision: the model follows the configuration's dtype. Under the caller's
autocast (training: float32 master parameters) every product runs in the
autocast dtype, and each float32 weight is cast to it once per call
(:class:`Cast`), not at every step: a decode's backward keeps one copy of
the weights in that dtype (4.7 GB at the published widths in bfloat16)
instead of one a step, and the gradient of that copy sums a decode's
steps in its dtype, as autocast's own weight cache does in an eager step.
Norms, RoPE, the residual stream and the softmaxes are float32. In serving
the parameters themselves are in the compute dtype, as the LSTM's are.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.sampling import hard_sample_st
from .moe import SparseMoE, _uniform_
from .transformer import dropout

LAYER_TYPES = ("conv", "conv", "full_attention", "conv", "conv", "conv", "full_attention",
               "conv", "conv", "conv", "full_attention", "conv", "conv", "conv",
               "full_attention", "conv", "conv", "conv", "full_attention", "conv", "conv",
               "full_attention", "conv", "conv")
PUBLISHED = dict(d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64, d_ff=7168, d_expert=1792,
                 n_experts=32, top_k=4, n_dense=2, conv_width=3, rope_theta=1e6,
                 norm_eps=1e-5, init_std=0.02)
MASK_VALUE = -1e30
GENERATE_MODES = ("st", "sched", "greedy")


class Cast:
    """The model's weights in ``dtype``, each cast once (kept for the
    call that made this object)."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.done: dict[int, torch.Tensor] = {}

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        if p.dtype == self.dtype:
            return p
        out = self.done.get(id(p))
        if out is None:
            out = self.done[id(p)] = p.to(self.dtype)
        return out


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight.float()


def _linear(x, weight, cast):
    return F.linear(x.to(cast.dtype), cast(weight))


class ShortConv(nn.Module):
    """The gated short convolution; ``state`` the last ``width - 1`` rows of
    ``u`` before this block (None: zeros)."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.in_proj = nn.Linear(d, 3 * d, bias=False)
        self.conv_weight = nn.Parameter(torch.empty(d, width))
        self.out_proj = nn.Linear(d, d, bias=False)

    def forward(self, x, cast, pos0: int, state=None):
        B, P, d = x.shape
        b, c, xt = _linear(x, self.in_proj.weight, cast).chunk(3, dim=-1)
        u = b * xt
        W = self.conv_weight.shape[1]
        if state is None:
            state = u.new_zeros(B, W - 1, d)
        window = torch.cat([state, u], dim=1)
        w = cast(self.conv_weight)
        v = sum(window[:, j:j + P] * w[:, j] for j in range(W))
        return _linear(c * v, self.out_proj.weight, cast), window[:, P:]


def rope(pos0: int, P: int, head_dim: int, theta: float, device):
    """(cos, sin), each (P, head_dim) float32, of positions pos0..pos0+P-1."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device, dtype=torch.float32)
                          / head_dim)
    ang = torch.arange(pos0, pos0 + P, device=device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


class GQAttention(nn.Module):
    """Grouped-query attention with q/k norms and RoPE; ``state`` the (K, V)
    of the positions before this block, each (B, S, n_kv, hd), or None."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int, theta: float,
                 eps: float):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim, self.theta = n_heads, n_kv, head_dim, theta
        self.q_proj = nn.Linear(d, n_heads * head_dim, bias=False)
        self.k_proj = nn.Linear(d, n_kv * head_dim, bias=False)
        self.v_proj = nn.Linear(d, n_kv * head_dim, bias=False)
        self.out_proj = nn.Linear(n_heads * head_dim, d, bias=False)
        self.q_layernorm = RMSNorm(head_dim, eps)
        self.k_layernorm = RMSNorm(head_dim, eps)

    def forward(self, x, cast, pos0: int, state=None):
        B, P, _ = x.shape
        H, KV, hd, dt = self.n_heads, self.n_kv, self.head_dim, cast.dtype
        q = self.q_layernorm(_linear(x, self.q_proj.weight, cast).view(B, P, H, hd))
        k = self.k_layernorm(_linear(x, self.k_proj.weight, cast).view(B, P, KV, hd))
        v = _linear(x, self.v_proj.weight, cast).view(B, P, KV, hd)
        cos, sin = rope(pos0, P, hd, self.theta, x.device)
        q, k = _rotate(q, cos, sin).to(dt), _rotate(k, cos, sin).to(dt)
        if state is not None:
            k, v = torch.cat([state[0], k], dim=1), torch.cat([state[1], v], dim=1)
        S = k.shape[1]
        kh, vh = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kh) / math.sqrt(hd)
        if P > 1:  # query i sits at key S - P + i
            causal = torch.ones(P, S, dtype=torch.bool, device=x.device).tril(S - P)
            scores = scores.masked_fill(~causal, MASK_VALUE)
        attn = scores.float().softmax(dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, P, H * hd)
        return _linear(out, self.out_proj.weight, cast), (k, v)


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.w1 = nn.Linear(d, d_ff, bias=False)
        self.w3 = nn.Linear(d, d_ff, bias=False)
        self.w2 = nn.Linear(d_ff, d, bias=False)

    def forward(self, x, cast):
        h = F.silu(_linear(x, self.w1.weight, cast)) * _linear(x, self.w3.weight, cast)
        return _linear(h, self.w2.weight, cast)


class Lfm2Layer(nn.Module):
    def __init__(self, kind: str, dense: bool, w: dict):
        super().__init__()
        d = w["d_model"]
        self.operator_norm = RMSNorm(d, w["norm_eps"])
        self.ffn_norm = RMSNorm(d, w["norm_eps"])
        if kind == "conv":
            self.mixer = ShortConv(d, w["conv_width"])
        elif kind == "full_attention":
            self.mixer = GQAttention(d, w["n_heads"], w["n_kv_heads"], w["head_dim"],
                                     w["rope_theta"], w["norm_eps"])
        else:
            raise ValueError(f"layer type must be conv or full_attention, got {kind!r}")
        self.feed_forward = (SwiGLU(d, w["d_ff"]) if dense else
                             SparseMoE(d, w["d_expert"], w["n_experts"], w["top_k"]))

    def forward(self, h, cast, pos0: int, state=None):
        out, state = self.mixer(self.operator_norm(h), cast, pos0, state)
        h = h + out
        B, P, d = h.shape
        return h + self.feed_forward(self.ffn_norm(h).reshape(B * P, d), cast).view(B, P, d), state


class Lfm2MoeGenerator(nn.Module):
    def __init__(self, n_vocab: int, n_class: int, max_len: int, p_drop: float = 0.1,
                 seed: int = 0, n_layers: int = len(LAYER_TYPES), **widths):
        super().__init__()
        if not 1 <= n_layers <= len(LAYER_TYPES):
            raise ValueError(f"n_layers must be 1..{len(LAYER_TYPES)}, got {n_layers}")
        w = {**PUBLISHED, **widths}
        self.n_vocab, self.max_len, self.p_drop, self.init_std = n_vocab, max_len, p_drop, \
            w["init_std"]
        d = w["d_model"]
        self.token_embedding = nn.Embedding(n_vocab, d)
        self.style_embedding = nn.Embedding(n_class, d)
        self.start_embedding = nn.Embedding(1, d)
        self.layers = nn.ModuleList(Lfm2Layer(kind, i < w["n_dense"], w)
                                    for i, kind in enumerate(LAYER_TYPES[:n_layers]))
        self.embedding_norm = RMSNorm(d, w["norm_eps"])
        self._shared: Cast | None = None
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Drawn from ``generator`` (on its own device, copied to the
        parameters'), in module order."""
        dev = generator.device
        for emb in (self.token_embedding, self.style_embedding, self.start_embedding):
            emb.weight.copy_(torch.randn(emb.weight.shape, generator=generator, device=dev)
                             * self.init_std)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _uniform_(m.weight, 1.0 / math.sqrt(m.in_features), generator)
            elif isinstance(m, ShortConv):
                _uniform_(m.conv_weight, 1.0 / math.sqrt(m.conv_weight.shape[1]), generator)
            elif isinstance(m, SparseMoE):
                m.reset_parameters_from(generator)

    def cast(self, device: torch.device) -> Cast:
        """A :class:`Cast` to the dtype products run in: the caller's
        autocast dtype, else the parameters' own; inside :meth:`one_cast`
        the one it holds."""
        if torch.is_autocast_enabled(device.type):
            dtype = torch.get_autocast_dtype(device.type)
        else:
            dtype = self.token_embedding.weight.dtype
        if self._shared is not None and self._shared.dtype == dtype:
            return self._shared
        return Cast(dtype)

    @contextlib.contextmanager
    def one_cast(self):
        """The calls inside (under the caller's autocast) share one cast of
        the weights: the optimize G step's decode and back-translation pass
        keep one copy and sum one gradient, not two. The weights must not
        change inside."""
        self._shared = None
        self._shared = self.cast(self.token_embedding.weight.device)
        try:
            yield
        finally:
            self._shared = None

    def _drop(self, t, generator):
        return dropout(t, self.p_drop, self.training, generator)

    def source(self, inp, label_i, cast, generator=None):
        """The embedded source (ids (B, L) or soft (B, L, V)) in style
        ``label_i``, dropout applied: (B, L, d) float32."""
        table = self.token_embedding.weight
        if torch.is_floating_point(inp):
            e = (hard_sample_st(inp.float()).to(cast.dtype) @ cast(table)).float()
        else:
            e = F.embedding(inp.long(), table).float()
        return self._drop(e + self.style_embedding(label_i.long()).float()[:, None, :],
                          generator)

    def bos(self, B: int, device) -> torch.Tensor:
        """The start embedding, (B, 1, d) float32."""
        return self.start_embedding.weight.float()[None].expand(B, 1, -1)

    def run(self, h, cast, pos0: int, states=None):
        """Every layer over h (B, P, d) at positions pos0..pos0+P-1, after the
        positions ``states`` (one per layer, or None) hold: (h, the new
        states). With gradients each layer is checkpointed (its inputs kept,
        its forward run again in the backward)."""
        new = []
        for layer, state in zip(self.layers, states or [None] * len(self.layers)):
            if torch.is_grad_enabled():
                h, state = checkpoint(layer, h, cast, pos0, state, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                h, state = layer(h, cast, pos0, state)
            new.append(state)
        return h, new

    def head(self, h, cast):
        return _linear(self.embedding_norm(h), self.token_embedding.weight, cast)

    def forward(self, inp, label_i, x, label, generator: torch.Generator | None = None):
        """The teacher-forced ``sched`` pass: logits (B, L, V) of x (B, L)
        from ``inp`` in style ``label_i``, to style ``label``."""
        cast = self.cast(x.device)
        src = self.source(inp, label_i, cast, generator)
        B = x.shape[0]
        tgt = torch.cat([self.bos(B, x.device),
                         F.embedding(x[:, :-1].long(), self.token_embedding.weight).float()], 1)
        tgt = self._drop(tgt + self.style_embedding(label.long()).float()[:, None, :], generator)
        h, _ = self.run(torch.cat([src, tgt], dim=1), cast, 0)
        return self.head(h[:, src.shape[1]:], cast)


def generate(model: Lfm2MoeGenerator, inp, label_i, label, mode: str = "greedy",
             tau: float = 1.0, generator: torch.Generator | None = None,
             L_out: int | None = None):
    """Autoregressive decode over ``L_out`` (default ``max_len``) cached
    steps after one pass over the source. Returns probs softmax(logits /
    tau) (B, L, V) for ``st`` (the next input is the straight-through hard
    sample times the embedding table), logits (B, L, V) for ``sched``
    (greedy feedback), ids (B, L) int32 for ``greedy``. Dropout (in train
    mode) from ``generator``."""
    if mode not in GENERATE_MODES:
        raise ValueError(f"generate: mode must be one of {GENERATE_MODES}, got {mode!r}")
    L = model.max_len if L_out is None else L_out
    cast = model.cast(inp.device)
    src = model.source(inp, label_i, cast, generator)
    _, states = model.run(src, cast, 0)
    B, pos = src.shape[0], src.shape[1]
    style = model.style_embedding(label.long()).float()[:, None, :]
    table = model.token_embedding.weight
    x_t = model.bos(B, inp.device)
    outs = []
    for t in range(L):
        h, states = model.run(model._drop(x_t + style, generator), cast, pos + t, states)
        logits_t = model.head(h, cast)[:, 0]
        if mode == "st":
            out_t = torch.softmax(logits_t / tau, dim=-1)
            x_t = (hard_sample_st(out_t).to(cast.dtype) @ cast(table)).float()[:, None, :]
        else:
            ids_t = logits_t.argmax(dim=-1)
            x_t = F.embedding(ids_t, table).float()[:, None, :]
            out_t = ids_t.to(torch.int32) if mode == "greedy" else logits_t
        outs.append(out_t)
    return torch.stack(outs, dim=1)
