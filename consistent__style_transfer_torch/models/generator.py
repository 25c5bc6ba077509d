"""Style-conditioned denoising seq2seq generator: the port of the JAX
package's ``models/generator.py::DenoiseSeq2Seq`` (the reference's
``DenoiseLSTM``, ``src/model/rnn.py``), for greedy decoding.

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
with ``load_state_dict(strict=True)``. The whole module runs in its parameter
dtype (``.to(torch.bfloat16)`` for the default compute dtype), which is what
flax's ``dtype=bf16`` does: inputs and weights cast to bf16, carries kept in
bf16.

Decode modes of this slice (inference; dropout and the teacher-forced, st and
gumbel modes come with the training slice):
- ``mode="greedy"``: token ids (B, max_len) int32. With ``rep_penalty == 0``
  the FFN -> vocab -> argmax head is :func:`fused_decode_logits`, a CUDA
  kernel on the card; with ``rep_penalty > 0`` it is the unfused head minus
  ``rep_penalty * counts``, where only ids >= 3 are counted.
- ``mode="sched"`` with ``x=None``: the same greedy decode, returning the
  logits (B, max_len, V).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.decode_step import fused_decode_logits
from . import initializers as init

D_EMBED = 128
D_ENC = 256
D_DEC = 512


class LSTM(nn.Module):
    """One LSTM layer with torch's gate order (i, f, g, o), holding
    ``nn.LSTM``'s parameter names (``weight_ih_l0``, ..., plus a ``_reverse``
    set when bidirectional). :meth:`cell` is one step; :meth:`scan` runs it
    over a sequence."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool = False):
        super().__init__()
        self.hidden = hidden
        for sfx in ("", "_reverse") if bidirectional else ("",):
            for name, cols in (("weight_ih", input_size), ("weight_hh", hidden)):
                self.register_parameter(f"{name}_l0{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden, cols)))
            for name in ("bias_ih", "bias_hh"):
                self.register_parameter(f"{name}_l0{sfx}", nn.Parameter(torch.empty(4 * hidden)))

    def cell(self, x, h, c, reverse: bool = False):
        """(x (B, in), h, c (B, hidden)) -> (h, c) after one step."""
        sfx = "_reverse" if reverse else ""
        gates = (F.linear(x, getattr(self, f"weight_ih_l0{sfx}"), getattr(self, f"bias_ih_l0{sfx}"))
                 + F.linear(h, getattr(self, f"weight_hh_l0{sfx}"), getattr(self, f"bias_hh_l0{sfx}")))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def scan(self, xs, h, c, reverse: bool = False):
        """xs (B, L, in), read from t=0 on -> (outputs (B, L, hidden), (h, c))."""
        outs = []
        for t in range(xs.shape[1]):
            h, c = self.cell(xs[:, t], h, c, reverse)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)


class DenoiseSeq2Seq(nn.Module):
    def __init__(self, n_vocab: int, n_class: int, max_len: int,
                 rep_penalty: float = 0.0, seed: int = 0):
        super().__init__()
        self.n_vocab = n_vocab
        self.max_len = max_len
        self.rep_penalty = rep_penalty  # greedy decode repetition penalty (alpha)
        self.start_embedding = nn.Embedding(1, D_EMBED)
        self.token_embedding = nn.Embedding(n_vocab, D_EMBED)
        self.enc_style_embedding = nn.Embedding(n_class, 2 * D_ENC)
        self.style_embedding = nn.Embedding(n_class, D_DEC)
        self.encoder = LSTM(D_EMBED, D_ENC, bidirectional=True)
        self.decoder = LSTM(D_EMBED, D_DEC)
        self.transfer = nn.Linear(2 * D_ENC, D_DEC, bias=False)
        self.fn_1 = nn.Linear(D_DEC + 2 * D_ENC, D_DEC)
        self.fn_2 = nn.Linear(D_DEC, n_vocab, bias=False)
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

    def encode(self, inp, label_i):
        """inp (B, L) ids -> (memory (B, L, 2*D_ENC), [c_fwd; c_bwd] (B, 2*D_ENC))."""
        e = self.token_embedding(inp)
        h0_f, h0_b = self.enc_style_embedding(label_i).chunk(2, dim=-1)
        c0 = torch.zeros_like(h0_f)
        mem_f, (_, c_f) = self.encoder.scan(e, h0_f, c0)
        # full-length flip of the padded sequence, as the JAX package does
        mem_b, (_, c_b) = self.encoder.scan(e.flip(1), h0_b, c0, reverse=True)
        memory = torch.cat([mem_f, mem_b.flip(1)], dim=-1)
        return memory, torch.cat([c_f, c_b], dim=-1)

    def forward(self, inp, label_i, x, label, mode: str = "sched"):
        """Greedy decode of ``max_len`` steps from ``inp`` (B, L) in style
        ``label_i`` to style ``label``. Returns ids (B, max_len) int32 for
        ``mode="greedy"``, logits (B, max_len, V) for ``mode="sched"``."""
        if x is not None or mode not in ("greedy", "sched"):
            raise NotImplementedError(
                "this slice of the port decodes greedily (mode 'greedy', or 'sched' "
                "with x=None); teacher forcing and the training modes come later (ROADMAP.md)")
        inp, label_i, label = inp.long(), label_i.long(), label.long()
        memory, c_end = self.encode(inp, label_i)
        B = inp.shape[0]
        h = self.style_embedding(label)
        c = F.leaky_relu(self.transfer(c_end), 0.1)
        x_t = self.start_embedding(torch.zeros(B, dtype=torch.long, device=inp.device))
        # sqrt in the compute dtype, as the JAX package takes it
        scale = memory.new_tensor(memory.shape[-1]).sqrt()
        greedy = mode == "greedy"
        counts = None
        if greedy and self.rep_penalty > 0:
            counts = memory.new_zeros(B, self.n_vocab)
            rows = torch.arange(B, device=inp.device)
        outs = []
        for _ in range(self.max_len):
            h, c = self.decoder.cell(x_t, h, c)
            # attention over every memory position: PADs included, no mask
            scores = torch.bmm(memory, h.unsqueeze(-1)).squeeze(-1) / scale
            a_t = torch.bmm(scores.softmax(dim=-1).unsqueeze(1), memory).squeeze(1)
            i_ffn = torch.cat([h, a_t], dim=-1)
            if greedy and counts is None:
                ids_t, _ = fused_decode_logits(i_ffn, self.fn_1.weight, self.fn_1.bias,
                                               self.fn_2.weight)
                out_t = ids_t
            else:
                logits_t = self.fn_2(F.leaky_relu(self.fn_1(i_ffn), 0.1))
                if counts is not None:
                    # the penalty acts before the argmax, so the fused head
                    # cannot carry it
                    logits_t = logits_t - self.rep_penalty * counts
                ids_t = logits_t.argmax(dim=-1).to(torch.int32)
                if counts is not None:
                    # count only content tokens (ids >= 3): PAD/BOS/EOS stay free
                    counts.index_put_((rows, ids_t.long()), (ids_t >= 3).to(counts.dtype),
                                      accumulate=True)
                out_t = ids_t if greedy else logits_t
            x_t = self.token_embedding(ids_t)
            outs.append(out_t)
        return torch.stack(outs, dim=1)  # batch-major: (B, L) ids or (B, L, V)


@torch.inference_mode()
def greedy_transfer(model: DenoiseSeq2Seq, x, labels):
    """Transfer x (B, L) to the opposite style with greedy decode (reference
    test path, ``src/main_optimize.py:157-164``): ids (B, max_len) int32."""
    return model(x, labels, None, 1 - labels, mode="greedy")
