"""Style-conditioned denoising seq2seq generator: the port of the JAX
package's ``models/generator.py::DenoiseSeq2Seq`` (the reference's
``DenoiseLSTM``, ``src/model/rnn.py``).

Architecture (dims from ``src/model/rnn.py:11-14``):
- token embedding d=128; encoder = 1-layer BiLSTM hidden=256 whose initial
  hidden state is the *input-style* embedding split into its forward and
  backward halves, initial cell zero. The backward direction reads the whole
  padded sequence flipped, as the JAX package does; it is not length-aware;
- decoder = 1-layer LSTM hidden=512, initial h = *target-style* embedding,
  initial c = LeakyReLU_0.1(transfer([c_fwd; c_bwd]));
- per step: dot-product attention of the decoder output over every encoder
  memory position (PADs included, no mask), scaled by sqrt(512), then
  FFN([o_t; a_t]) -> LeakyReLU_0.1 -> vocab logits.

Attribute names are the reference's state-dict keys (``encoder.weight_ih_l0``,
``encoder.weight_ih_l0_reverse``, ``fn_2.weight``, ``transfer.weight``, ...),
so its ``.pth`` checkpoints and those of the JAX package's ``save_pth`` load
with ``load_state_dict(strict=True)``. For serving the module runs in its
parameter dtype (``.to(torch.bfloat16)``, what flax's ``dtype=bf16`` does);
the training stages keep float32 parameters and run it under
``torch.autocast``. There a call casts each weight that a product reads
once (:meth:`DenoiseSeq2Seq.one_cast`, ``models/weight_cast.py``), not once
a timestep: the products take the values autocast gives them, and each
weight's gradient is one float32 product over a pass's stacked steps.

Decode modes (reference ``rnn.py:82-96``):
- ``mode="greedy"``: token ids (B, max_len) int32. With ``rep_penalty == 0``
  the FFN -> vocab -> argmax head is :func:`fused_decode_logits`, a CUDA
  kernel on the card; with ``rep_penalty > 0`` it is the unfused head minus
  ``rep_penalty * counts``, where only ids >= 3 are counted.
- ``mode="st"``: differentiable decode, probs softmax(logits / tau); the
  next input is the straight-through hard sample of the probs times the
  embedding table, so the gradient reaches both.
- ``mode="sched"``: scheduled sampling with a teacher ``x``: one coin a step
  for the whole batch (:func:`sched_coins`) feeds the teacher token's
  embedding (1) or the greedy token's (0); returns logits. With ``x=None``
  every step is greedy.
- ``mode="teacher"``: always teacher-forced logits.
- ``mode="gumbel"``: the reference's commented-out Gumbel-softmax variant
  (``rnn.py:86-89``; JAX ``models/generator.py:176-184``): probs
  softmax((logits + g) / tau) with g = -log(-log(U)), U uniform on
  [tiny, 1) as ``jax.random.gumbel`` draws it, from ``generator`` unless
  ``noise`` is given; straight-through feedback as in ``st``.

:func:`stateful_beam_decode` is the beam search on the trained model (one
encoder pass, K copies of the decoder state, the unfused head).

Dropout (``p_drop``, flax's inverted rule) acts in training mode only, at
three places as in the JAX package: the encoder's id embeddings, the FFN
input and each fed-back input; its masks come from an explicit
``torch.Generator``. Soft (B, L, V) encoder input is
``hard_sample_st(inp) @ table``, without dropout. Soft outputs come
batch-major (B, L, V), or time-major (L, B, V) with ``time_major_out``; ids
are always batch-major.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.decode_step import fused_decode_logits
from ..kernels.lstm_cell import lstm_cell
from ..ops.sampling import hard_sample_st
from . import initializers as init
from .transformer import dropout
from .weight_cast import Uses, WeightCast

D_EMBED = 128
D_ENC = 256
D_DEC = 512
P_DROP = 0.1
MODES = ("st", "sched", "greedy", "teacher", "gumbel")


def sched_coins(n: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """The coins of one sched-mode decode of ``n`` steps: one Bernoulli(0.5)
    a step for the whole batch, not one a row (``models/generator.py:292-296``
    of the JAX package); (n,) bool on ``device``."""
    return torch.rand(n, generator=generator, device=device) < 0.5


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)) in float32, U uniform on [tiny,
    1) as ``jax.random.gumbel`` draws it (its ``minval`` is the smallest
    normal float, so no log of 0)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class LSTM(nn.Module):
    """One LSTM layer with torch's gate order (i, f, g, o), holding
    ``nn.LSTM``'s parameter names (``weight_ih_l0``, ..., plus a ``_reverse``
    set when bidirectional). :meth:`cell` is one step: the two products, then
    :func:`~..kernels.lstm_cell.lstm_cell` (one CUDA kernel forward and one
    backward on the card, the plain equations on the CPU); :meth:`scan` runs
    it over a sequence."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool = False):
        super().__init__()
        self.hidden = hidden
        for sfx in ("", "_reverse") if bidirectional else ("",):
            for name, cols in (("weight_ih", input_size), ("weight_hh", hidden)):
                self.register_parameter(f"{name}_l0{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden, cols)))
            for name in ("bias_ih", "bias_hh"):
                self.register_parameter(f"{name}_l0{sfx}", nn.Parameter(torch.empty(4 * hidden)))

    def weights(self, reverse: bool = False) -> tuple:
        """(W_ih, b_ih, W_hh, b_hh) of one direction."""
        sfx = "_reverse" if reverse else ""
        return tuple(getattr(self, f"{n}_l0{sfx}")
                     for n in ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))

    def uses(self, reverse: bool = False, cast: WeightCast | None = None) -> tuple:
        """The input and the recurrent product of one direction for one pass
        (:class:`~.weight_cast.Uses`, reading ``cast``'s copies if given)."""
        w_ih, b_ih, w_hh, b_hh = self.weights(reverse)
        return Uses(w_ih, b_ih, cast=cast), Uses(w_hh, b_hh, cast=cast)

    def cell(self, x, h, c, reverse: bool = False, uses: tuple | None = None):
        """(x (B, in), h, c (B, hidden)) -> (h, c) after one step; ``uses``
        the pass's products (:meth:`uses`), else the weights themselves."""
        ih, hh = uses or self.uses(reverse)
        return lstm_cell(ih(x), hh(h), c)

    def scan(self, xs, h, c, reverse: bool = False, cast: WeightCast | None = None):
        """xs (B, L, in), read from t=0 on -> (outputs (B, L, hidden), (h, c))."""
        uses = self.uses(reverse, cast)
        outs = []
        for t in range(xs.shape[1]):
            h, c = self.cell(xs[:, t], h, c, reverse, uses)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)


class DenoiseSeq2Seq(nn.Module):
    def __init__(self, n_vocab: int, n_class: int, max_len: int,
                 rep_penalty: float = 0.0, p_drop: float = P_DROP, seed: int = 0):
        super().__init__()
        self.n_vocab = n_vocab
        self.max_len = max_len
        self.rep_penalty = rep_penalty  # greedy decode repetition penalty (alpha)
        self.p_drop = p_drop
        self.start_embedding = nn.Embedding(1, D_EMBED)
        self.token_embedding = nn.Embedding(n_vocab, D_EMBED)
        self.enc_style_embedding = nn.Embedding(n_class, 2 * D_ENC)
        self.style_embedding = nn.Embedding(n_class, D_DEC)
        self.encoder = LSTM(D_EMBED, D_ENC, bidirectional=True)
        self.decoder = LSTM(D_EMBED, D_DEC)
        self.transfer = nn.Linear(2 * D_ENC, D_DEC, bias=False)
        self.fn_1 = nn.Linear(D_DEC + 2 * D_ENC, D_DEC)
        self.fn_2 = nn.Linear(D_DEC, n_vocab, bias=False)
        self._cast: WeightCast | None = None
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh weights with the JAX package's distributions, drawn from
        ``generator`` (a CPU generator for a module on the CPU)."""
        for emb in (self.start_embedding, self.token_embedding,
                    self.enc_style_embedding, self.style_embedding):
            init.embedding_(emb.weight, generator)
        for lstm in (self.encoder, self.decoder):
            for p in lstm.parameters():
                init.lstm_(p, lstm.hidden, generator)
        init.linear_kernel_(self.transfer.weight, generator)
        init.linear_kernel_(self.fn_1.weight, generator)
        init.linear_bias_(self.fn_1.bias, self.fn_1.in_features, generator)
        init.linear_kernel_(self.fn_2.weight, generator)

    def product_weights(self) -> list[nn.Parameter]:
        """The 17 weights and biases that products read: both encoder
        directions, the decoder, ``transfer``, ``fn_1``, ``fn_2`` and the
        token table (the soft input's and the st/gumbel feedback's product)."""
        return [*self.encoder.weights(), *self.encoder.weights(reverse=True),
                *self.decoder.weights(), self.transfer.weight, self.fn_1.weight,
                self.fn_1.bias, self.fn_2.weight, self.token_embedding.weight]

    @contextlib.contextmanager
    def one_cast(self):
        """The calls inside share one cast of :meth:`product_weights` to the
        caller's autocast dtype (:class:`~.weight_cast.WeightCast`, counted
        as ``generator.weight_casts``), made here, so a CUDA graph that
        captures the scope recasts the updated masters at each replay; each
        weight's gradient is summed in float32. Engages only under autocast
        in a dtype other than the parameters' (the training stages); else
        the products read the weights themselves. The weights must not
        change inside."""
        table = self.token_embedding.weight
        kind, outer = table.device.type, self._cast
        if torch.is_autocast_enabled(kind) and torch.get_autocast_dtype(kind) != table.dtype:
            self._cast = WeightCast(self.product_weights(), torch.get_autocast_dtype(kind),
                                    "generator.weight_casts")
        try:
            yield
        finally:
            self._cast = outer

    def _uses(self, weight, bias=None, transposed: bool = False) -> Uses:
        return Uses(weight, bias, transposed, self._cast)

    def _drop(self, t, generator):
        return dropout(t, self.p_drop, self.training, generator)

    def encode(self, inp, label_i, generator=None):
        """inp: ids (B, L), or soft (B, L, V) -> (memory (B, L, 2*D_ENC),
        [c_fwd; c_bwd] (B, 2*D_ENC))."""
        if torch.is_floating_point(inp):
            table = self.token_embedding.weight
            e = self._uses(table, transposed=True)(hard_sample_st(inp.to(table.dtype)))
        else:
            e = self._drop(self.token_embedding(inp.long()), generator)
        h0_f, h0_b = self.enc_style_embedding(label_i).chunk(2, dim=-1)
        c0 = torch.zeros_like(h0_f)
        mem_f, (_, c_f) = self.encoder.scan(e, h0_f, c0, cast=self._cast)
        # full-length flip of the padded sequence, as the JAX package does
        mem_b, (_, c_b) = self.encoder.scan(e.flip(1), h0_b, c0, reverse=True, cast=self._cast)
        memory = torch.cat([mem_f, mem_b.flip(1)], dim=-1)
        return memory, torch.cat([c_f, c_b], dim=-1)

    def init_state(self, memory, c_end, label):
        """The decoder's first (h, c, x_t): h the target-style embedding, c
        LeakyReLU_0.1(transfer(c_end)), x_t the start embedding; and the
        attention scale sqrt(2*D_ENC), in the compute dtype, as the JAX
        package takes it, made on the device (no host copy, so a CUDA graph
        can capture it)."""
        h = self.style_embedding(label)
        c = F.leaky_relu(self._uses(self.transfer.weight)(c_end), 0.1)
        x_t = self.start_embedding(torch.zeros(memory.shape[0], dtype=torch.long,
                                               device=memory.device))
        scale = torch.full((), memory.shape[-1], dtype=memory.dtype, device=memory.device).sqrt()
        return h, c, x_t, scale

    def decoder_step(self, x_t, h, c, memory, scale, uses: tuple | None = None):
        """One decoder step before the head: the LSTM cell (through the
        pass's ``uses``, ``decoder.uses``, if given), then attention of its
        output over every memory position (PADs included, no mask).
        Returns (h, c, the FFN input [h; a_t]) without dropout."""
        h, c = self.decoder.cell(x_t, h, c, uses=uses)
        scores = torch.bmm(memory, h.unsqueeze(-1)).squeeze(-1) / scale
        a_t = torch.bmm(scores.softmax(dim=-1).unsqueeze(1), memory).squeeze(1)
        return h, c, torch.cat([h, a_t], dim=-1)

    def head_uses(self) -> tuple[Uses, Uses]:
        """``fn_1``'s and ``fn_2``'s products for one pass."""
        return self._uses(self.fn_1.weight, self.fn_1.bias), self._uses(self.fn_2.weight)

    def head(self, i_ffn, uses: tuple | None = None):
        """The unfused FFN head: vocab logits fn_2(LeakyReLU_0.1(fn_1(i_ffn))),
        through the pass's ``uses`` (:meth:`head_uses`) if given."""
        fn_1, fn_2 = uses or self.head_uses()
        return fn_2(F.leaky_relu(fn_1(i_ffn), 0.1))

    def forward(self, inp, label_i, x, label, mode: str = "sched", tau: float = 1.0,
                time_major_out: bool = False, generator: torch.Generator | None = None,
                coins: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """Decode from ``inp`` (ids (B, L) or soft (B, L, V)) in style
        ``label_i`` to style ``label``, over ``x.shape[1]`` steps when a
        teacher ``x`` (B, L) is given, else ``max_len``. Returns ids (B, L)
        int32 for ``greedy``, probs for ``st`` and ``gumbel``, logits for
        ``sched`` and ``teacher``: (B, L, V), or (L, B, V) with
        ``time_major_out``.

        ``generator`` draws the dropout masks (training mode), the Gumbel
        noise unless ``noise`` ((L, B, V), one draw a step) is given and, in
        ``sched`` mode with a teacher, the coins unless ``coins`` ((L,) bool,
        one a step) is given.

        A call other than ``greedy`` opens :meth:`one_cast` when none is
        open, so it casts the weights once."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "teacher" and x is None:
            raise ValueError("mode 'teacher' needs a teacher x")
        scope = (self.one_cast() if self._cast is None and mode != "greedy"
                 else contextlib.nullcontext())
        with scope:
            return self._decode(inp, label_i, x, label, mode, tau, time_major_out, generator,
                                coins, noise)

    def _decode(self, inp, label_i, x, label, mode, tau, time_major_out, generator, coins,
                noise):
        label_i, label = label_i.long(), label.long()
        memory, c_end = self.encode(inp, label_i, generator)
        B, device = memory.shape[0], memory.device
        h, c, x_t, scale = self.init_state(memory, c_end, label)
        table = self.token_embedding.weight
        L_out = self.max_len if x is None else x.shape[1]
        teacher = None
        if x is not None:
            teacher = F.embedding(x.long(), table)  # (B, L, E)
            if mode == "sched":
                coins = (sched_coins(L_out, generator, device) if coins is None
                         else coins.to(device=device, dtype=torch.bool))
        greedy = mode == "greedy"
        counts = None
        if greedy and self.rep_penalty > 0:
            counts = memory.new_zeros(B, self.n_vocab)
            rows = torch.arange(B, device=device)
        # each weight's products of this decode, one a step
        dec, head = self.decoder.uses(cast=self._cast), self.head_uses()
        feedback = self._uses(table, transposed=True) if mode in ("st", "gumbel") else None
        outs = []
        for t in range(L_out):
            h, c, i_ffn = self.decoder_step(x_t, h, c, memory, scale, dec)
            i_ffn = self._drop(i_ffn, generator)
            if greedy and counts is None:
                out_t, _ = fused_decode_logits(i_ffn, self.fn_1.weight, self.fn_1.bias,
                                               self.fn_2.weight)
                x_next = self.token_embedding(out_t)
            else:
                logits_t = self.head(i_ffn, head)
                if mode in ("st", "gumbel"):
                    if mode == "gumbel":
                        g = (gumbel_noise(logits_t.shape, generator, device) if noise is None
                             else noise[t])
                        logits_t = logits_t + g.to(logits_t.dtype)
                    out_t = torch.softmax(logits_t / tau, dim=-1)
                    x_next = feedback(hard_sample_st(out_t))
                elif greedy:
                    # the penalty acts before the argmax, so the fused head
                    # cannot carry it
                    logits_t = logits_t - self.rep_penalty * counts
                    out_t = logits_t.argmax(dim=-1).to(torch.int32)
                    # count only content tokens (ids >= 3): PAD/BOS/EOS stay free
                    counts.index_put_((rows, out_t.long()), (out_t >= 3).to(counts.dtype),
                                      accumulate=True)
                    x_next = self.token_embedding(out_t)
                elif mode == "teacher":
                    out_t, x_next = logits_t, teacher[:, t]
                else:  # sched: the coin picks the teacher token or the greedy one
                    out_t = logits_t
                    x_next = F.embedding(logits_t.argmax(dim=-1), table)
                    if teacher is not None:
                        x_next = torch.where(coins[t], teacher[:, t], x_next)
            x_t = self._drop(x_next, generator)
            outs.append(out_t)
        if greedy:
            return torch.stack(outs, dim=1)  # (B, L) ids
        return torch.stack(outs, dim=0 if time_major_out else 1)


@torch.inference_mode()
def greedy_transfer(model: DenoiseSeq2Seq, x, labels):
    """Transfer x (B, L) to the opposite style with greedy decode (reference
    test path, ``src/main_optimize.py:157-164``): ids (B, max_len) int32."""
    return model(x, labels, None, 1 - labels, mode="greedy")


@torch.inference_mode()
def stateful_beam_decode(model: DenoiseSeq2Seq, x, label_i, label, beam_size: int = 4,
                         length_penalty: float = 0.6):
    """Beam decode of x (B, L) on the trained ``model`` itself, the port of
    the JAX package's ``BeamDenoiseSeq2Seq``: one encoder pass on the
    un-tiled batch, then K copies of (h, c, memory); beams 1..K-1 start at
    -1e9 so the K equal start states do not give K copies of the greedy
    path. Each of the ``max_len`` steps takes log_softmax in float32 over
    the unfused FFN head, the top K of the K*V sums and a gather of the
    kept beams' rows. Without dropout, in the model's dtype. Returns (ids
    (B, max_len) int32, scores (B,) = the best beam's sum / L ** 0.6)."""
    from .beam import best_beam

    if model.training:
        raise ValueError("beam decode runs the model in eval mode (no dropout)")
    K, L, V = beam_size, model.max_len, model.n_vocab
    label_i, label = label_i.long(), label.long()
    memory, c_end = model.encode(x, label_i)
    B, device = memory.shape[0], memory.device
    h, c, x_t, scale = model.init_state(memory, c_end, label)
    h, c, x_t, memory = (t.repeat_interleave(K, 0) for t in (h, c, x_t, memory))
    table = model.token_embedding.weight
    scores = torch.full((B, K), -1e9, device=device)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    seqs = torch.zeros(B * K, L, dtype=torch.int32, device=device)
    group = torch.arange(B, device=device)[:, None] * K  # each sentence's first row
    for t in range(L):
        h, c, i_ffn = model.decoder_step(x_t, h, c, memory, scale)
        logp = torch.log_softmax(model.head(i_ffn).float(), dim=-1)
        scores, flat = (scores[:, None] + logp).reshape(B, K * V).topk(K, dim=-1)
        tok = flat % V
        rows = (group + flat // V).reshape(-1)
        h, c, seqs = h[rows], c[rows], seqs[rows]
        seqs[:, t] = tok.reshape(-1).to(torch.int32)
        scores = scores.reshape(-1)
        x_t = F.embedding(tok.reshape(-1), table)
    return best_beam(seqs, scores, B, K, L, length_penalty)
