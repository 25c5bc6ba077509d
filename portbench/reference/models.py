"""The plain reference of the port's models: float32 PyTorch, no kernels, no
CUDA graphs, no autocast. A frozen copy of the equations of the reference
repository's models (``src/model/{rnn,classifier,match,mlm,discriminator}.py``)
in the parameter names of their state dicts, so the benchmark can load one
set of seeded weights into this module and into the port's.

Dropout draws its masks with ``torch.rand(shape, generator=g) >= p`` in the
same order as the port does, so the reference given generators seeded alike
draws the same masks, step for step. It imports nothing of the port.

``init_bounds`` gives, for each state-dict key, the (centre, half-width) of
the uniform distribution the benchmark draws its seeded weights from: the
bounds of the reference's own initialisers (torch's defaults, RelGAN's
normal for the discriminator), a normal replaced by the uniform of the same
standard deviation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

SQRT3 = math.sqrt(3.0)


def dropout(x, p: float, training: bool, generator):
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def hard_sample_st(probs):
    """one_hot(argmax(p)) forward, identity backward (straight-through)."""
    hard = torch.zeros_like(probs).scatter_(-1, probs.argmax(dim=-1, keepdim=True), 1.0)
    return hard - probs.detach() + probs


def embed_or_project(x, table, time_major: bool = False):
    if not torch.is_floating_point(x):
        return F.embedding(x.long(), table)
    out = x @ table
    return out.transpose(0, 1) if time_major else out


# ----------------------------------------------------------------- generator
class LSTM(nn.Module):
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
        sfx = "_reverse" if reverse else ""
        gates = (F.linear(x, getattr(self, f"weight_ih_l0{sfx}"), getattr(self, f"bias_ih_l0{sfx}"))
                 + F.linear(h, getattr(self, f"weight_hh_l0{sfx}"),
                            getattr(self, f"bias_hh_l0{sfx}")))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def scan(self, xs, h, c, reverse: bool = False):
        outs = []
        for t in range(xs.shape[1]):
            h, c = self.cell(xs[:, t], h, c, reverse)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)


class Generator(nn.Module):
    """The denoising LSTM seq2seq (``src/model/rnn.py``): a bidirectional
    encoder started from the input style, a decoder started from the target
    style and the transferred encoder cell, dot attention over every memory
    position, the head fn_2(LeakyReLU_0.1(fn_1([h; a])))."""

    def __init__(self, n_vocab: int, n_class: int, max_len: int, d_embed: int, d_enc: int,
                 d_dec: int, p_drop: float):
        super().__init__()
        self.n_vocab, self.max_len, self.p_drop = n_vocab, max_len, p_drop
        self.start_embedding = nn.Embedding(1, d_embed)
        self.token_embedding = nn.Embedding(n_vocab, d_embed)
        self.enc_style_embedding = nn.Embedding(n_class, 2 * d_enc)
        self.style_embedding = nn.Embedding(n_class, d_dec)
        self.encoder = LSTM(d_embed, d_enc, bidirectional=True)
        self.decoder = LSTM(d_embed, d_dec)
        self.transfer = nn.Linear(2 * d_enc, d_dec, bias=False)
        self.fn_1 = nn.Linear(d_dec + 2 * d_enc, d_dec)
        self.fn_2 = nn.Linear(d_dec, n_vocab, bias=False)

    def _drop(self, t, generator):
        return dropout(t, self.p_drop, self.training, generator)

    def encode(self, inp, label_i, generator=None):
        if torch.is_floating_point(inp):
            e = hard_sample_st(inp) @ self.token_embedding.weight
        else:
            e = self._drop(self.token_embedding(inp.long()), generator)
        h0_f, h0_b = self.enc_style_embedding(label_i).chunk(2, dim=-1)
        c0 = torch.zeros_like(h0_f)
        mem_f, (_, c_f) = self.encoder.scan(e, h0_f, c0)
        mem_b, (_, c_b) = self.encoder.scan(e.flip(1), h0_b, c0, reverse=True)
        return torch.cat([mem_f, mem_b.flip(1)], dim=-1), torch.cat([c_f, c_b], dim=-1)

    def init_state(self, memory, c_end, label):
        h = self.style_embedding(label)
        c = F.leaky_relu(self.transfer(c_end), 0.1)
        x_t = self.start_embedding(torch.zeros(memory.shape[0], dtype=torch.long,
                                               device=memory.device))
        return h, c, x_t, math.sqrt(memory.shape[-1])

    def decoder_step(self, x_t, h, c, memory, scale):
        h, c = self.decoder.cell(x_t, h, c)
        scores = torch.bmm(memory, h.unsqueeze(-1)).squeeze(-1) / scale
        a_t = torch.bmm(scores.softmax(dim=-1).unsqueeze(1), memory).squeeze(1)
        return h, c, torch.cat([h, a_t], dim=-1)

    def head(self, i_ffn):
        return self.fn_2(F.leaky_relu(self.fn_1(i_ffn), 0.1))

    def forward(self, inp, label_i, x, label, mode: str = "sched", tau: float = 1.0,
                time_major_out: bool = False, generator=None, coins=None, alter=None):
        """The decode modes the benchmark checks: ``st`` (probs, straight-
        through feedback) and ``sched`` with a teacher and one coin a step.
        ``alter``
        (a callable on the straight-through one-hot a step feeds back)
        plants a fault for the control runs."""
        label_i, label = label_i.long(), label.long()
        memory, c_end = self.encode(inp, label_i, generator)
        h, c, x_t, scale = self.init_state(memory, c_end, label)
        table = self.token_embedding.weight
        L_out = self.max_len if x is None else x.shape[1]
        teacher = None
        if x is not None:
            teacher = F.embedding(x.long(), table)
            if mode == "sched" and coins is None:
                coins = torch.rand(L_out, generator=generator, device=memory.device) < 0.5
        outs = []
        for t in range(L_out):
            h, c, i_ffn = self.decoder_step(x_t, h, c, memory, scale)
            i_ffn = self._drop(i_ffn, generator)
            logits_t = self.head(i_ffn)
            if mode == "st":
                out_t = torch.softmax(logits_t / tau, dim=-1)
                hard = hard_sample_st(out_t)
                x_next = (hard if alter is None else alter(hard)) @ table
            else:
                out_t = logits_t
                x_next = F.embedding(logits_t.argmax(dim=-1), table)
                if teacher is not None:
                    x_next = torch.where(coins[t], teacher[:, t], x_next)
            x_t = self._drop(x_next, generator)
            outs.append(out_t)
        return torch.stack(outs, dim=0 if time_major_out else 1)


def forced_st_logits(model: Generator, x, label_i, label, feed, generator=None):
    """Logits (B, L, V) of each step of the straight-through decode of
    ``x`` to ``label`` when each step feeds back ``feed`` (B, L) instead
    of its own argmax: the reference's scores of the tokens a training
    step produced, along the program's own path. Its dropout draws are
    those of the ``st`` decode, in the same order."""
    memory, c_end = model.encode(x, label_i.long(), generator)
    h, c, x_t, scale = model.init_state(memory, c_end, label.long())
    out = []
    for t in range(feed.shape[1]):
        h, c, i_ffn = model.decoder_step(x_t, h, c, memory, scale)
        out.append(model.head(model._drop(i_ffn, generator)))
        x_t = model._drop(F.embedding(feed[:, t].long(), model.token_embedding.weight), generator)
    return torch.stack(out, dim=1)



# ------------------------------------------------------------------ scorers
class SelfAttention(nn.Module):
    def __init__(self, d: int, n_heads: int, p_drop: float):
        super().__init__()
        self.d, self.n_heads, self.p_drop = d, n_heads, p_drop
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, generator=None):
        B, L, d = x.shape
        h, hd = self.n_heads, d // self.n_heads
        q, k, v = (t.reshape(B, L, h, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).split(d, dim=-1))
        attn = dropout((q @ k.transpose(-1, -2) / math.sqrt(hd)).softmax(dim=-1), self.p_drop,
                       self.training, generator)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, L, d))


class EncoderLayer(nn.Module):
    """Post-LN ``nn.TransformerEncoderLayer`` (relu FFN, LayerNorm 1e-5)."""

    def __init__(self, d: int, n_heads: int, d_ff: int, p_drop: float):
        super().__init__()
        self.p_drop = p_drop
        self.self_attn = SelfAttention(d, n_heads, p_drop)
        self.linear1 = nn.Linear(d, d_ff)
        self.linear2 = nn.Linear(d_ff, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, generator=None):
        def drop(t):
            return dropout(t, self.p_drop, self.training, generator)
        x = self.norm1(x + drop(self.self_attn(x, generator)))
        y = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm2(x + drop(y))


class Encoder(nn.Module):
    def __init__(self, n_layers: int, d: int, n_heads: int, d_ff: int, p_drop: float):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d, n_heads, d_ff, p_drop)
                                    for _ in range(n_layers))

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator)
        return x


class TextCNN(nn.Module):
    """Kim-CNN (``src/model/classifier.py``): windows of 3, 4 and 5 tokens
    padded k-1 at both ends, ReLU, max over time, dropout, a linear."""

    def __init__(self, n_vocab: int, n_class: int, d_embed: int, kernels, n_filters,
                 p_drop: float):
        super().__init__()
        self.kernels, self.p_drop = tuple(kernels), p_drop
        self.embedding = nn.Embedding(n_vocab, d_embed)
        self.convs = nn.ModuleList(nn.Conv2d(1, n, (k, d_embed)) for k, n in
                                   zip(self.kernels, n_filters))
        self.out = nn.Linear(sum(n_filters), n_class)

    def forward(self, x, generator=None, time_major: bool = False):
        e = embed_or_project(x, self.embedding.weight, time_major)
        pooled = []
        for conv, k in zip(self.convs, self.kernels):
            windows = F.pad(e, (0, 0, k - 1, k - 1)).unfold(1, k, 1).transpose(2, 3).flatten(2)
            pooled.append(F.relu(F.linear(windows, conv.weight.flatten(1), conv.bias)).amax(1))
        return self.out(dropout(torch.cat(pooled, -1), self.p_drop, self.training, generator))


class PairMatcher(nn.Module):
    """The content matcher (``src/model/match.py``): token, position
    (restarting per sentence) and segment embeddings, the encoder, max over
    time, a linear to one score."""

    def __init__(self, n_vocab: int, d: int, n_heads: int, n_layers: int, d_ff: int,
                 max_pos: int, p_drop: float):
        super().__init__()
        self.token_embedding = nn.Embedding(n_vocab, d)
        self.posit_embedding = nn.Embedding(max_pos, d)
        self.segment_embedding = nn.Embedding(2, d)
        self.matcher = Encoder(n_layers, d, n_heads, d_ff, p_drop)
        self.hidden2logits = nn.Linear(d, 1)

    def _embed(self, x, segment: int, time_major: bool = False):
        e = embed_or_project(x, self.token_embedding.weight, time_major)
        return (e + self.posit_embedding.weight[: e.shape[1]]
                + self.segment_embedding.weight[segment])

    def forward(self, x1, x2, generator=None, time_major: bool = False):
        h = torch.cat([self._embed(x1, 0, time_major), self._embed(x2, 1)], dim=1)
        return self.hidden2logits(self.matcher(h, generator).amax(dim=1))[:, 0]


class TransformerLM(nn.Module):
    """The LM denoiser (``src/model/mlm.py``): token and position
    embeddings, the encoder, a linear to the vocabulary."""

    def __init__(self, n_vocab: int, d: int, n_heads: int, n_layers: int, d_ff: int,
                 max_pos: int, p_drop: float):
        super().__init__()
        self.token_embedding = nn.Embedding(n_vocab, d)
        self.posit_embedding = nn.Embedding(max_pos, d)
        self.lm = Encoder(n_layers, d, n_heads, d_ff, p_drop)
        self.fwd = nn.Linear(d, n_vocab)

    def forward(self, x, generator=None):
        e = embed_or_project(x, self.token_embedding.weight)
        return self.fwd(self.lm(e + self.posit_embedding.weight[: e.shape[1]], generator))


class Discriminator(nn.Module):
    """RelGAN's multi-representation CNN (``src/model/discriminator.py``):
    a bias-free V -> d_embed projection in ``num_rep`` slices, convolutions
    over each slice, max over time, a highway, dropout, two linears: one
    logit per (sample, slice), row ``b * num_rep + r``."""

    def __init__(self, n_vocab: int, d_embed: int, num_rep: int, filter_sizes, num_filters,
                 p_drop: float):
        super().__init__()
        self.num_rep, self.filter_sizes, self.p_drop = num_rep, tuple(filter_sizes), p_drop
        width = d_embed // num_rep
        self.embeddings = nn.Linear(n_vocab, d_embed, bias=False)
        self.convs = nn.ModuleList(nn.Conv2d(1, n, (f, width), stride=(1, width))
                                   for n, f in zip(num_filters, filter_sizes))
        feat = sum(num_filters)
        self.highway = nn.Linear(feat, feat)
        self.feature2out = nn.Linear(feat, 100)
        self.out2logits = nn.Linear(100, 1)

    def forward(self, inp, generator=None, time_major: bool = False):
        e = embed_or_project(inp, self.embeddings.weight.t(), time_major)
        B, L, d = e.shape
        width = d // self.num_rep
        e = e.reshape(B, L, self.num_rep, width).transpose(1, 2).reshape(B * self.num_rep, L, width)
        pools = []
        for conv, f in zip(self.convs, self.filter_sizes):
            windows = e.unfold(1, f, 1).transpose(2, 3).flatten(2)
            pools.append(F.relu(F.linear(windows, conv.weight.flatten(1), conv.bias)).amax(dim=1))
        pred = torch.cat(pools, dim=-1)
        gate = self.highway(pred)
        pred = torch.sigmoid(gate) * F.relu(gate) + (1.0 - torch.sigmoid(gate)) * pred
        pred = dropout(pred, self.p_drop, self.training, generator)
        return self.out2logits(self.feature2out(pred))[:, 0]


# ------------------------------------------------------------- construction
def build(cfg: dict, device="cpu") -> dict[str, nn.Module]:
    """The five modules of a configuration file's widths (``generator``,
    ``classifier``, ``matcher``, ``lm``, ``disc``), uninitialised, on
    ``device`` ("meta" for shapes alone)."""
    V, g, s, d = cfg["vocab_size"], cfg["generator"], cfg["scorers"], cfg["discriminator"]
    c = cfg["classifier"]
    with torch.device(device):
        return {
            "generator": Generator(V, cfg["n_class"], cfg["max_len"], g["d_embed"], g["d_enc"],
                                   g["d_dec"], g["p_drop"]),
            "classifier": TextCNN(V, cfg["n_class"], c["d_embed"], c["kernels"], c["n_filters"],
                                  c["p_drop"]),
            "matcher": PairMatcher(V, s["d_model"], s["n_heads"], s["n_layers"], s["d_ff"],
                                   s["max_pos"], s["p_drop"]),
            "lm": TransformerLM(V, s["d_model"], s["n_heads"], s["n_layers"], s["d_ff"],
                                s["max_pos"], s["p_drop"]),
            "disc": Discriminator(V, d["d_embed"], d["num_rep"], d["filter_sizes"],
                                  d["num_filters"], d["p_drop"]),
        }


def init_bounds(name: str, module: nn.Module) -> dict[str, tuple[float, float]]:
    """(centre, half-width) of each state-dict key's uniform draw, from the
    reference's initialisers: linear U(+-1/sqrt(fan_in)); embedding N(0, 1)
    (half-width sqrt 3); LSTM U(+-1/sqrt(hidden)); the attention's input
    projection xavier, its bias 0; LayerNorm 1 and 0; the LM's position
    table xavier; every discriminator tensor N(0, 1/sqrt(shape[0]))."""
    out = {}
    for key, t in module.state_dict().items():
        shape = t.shape
        leaf = key.rsplit(".", 1)[-1]
        if name == "disc":
            out[key] = (0.0, SQRT3 / math.sqrt(shape[0]))
        elif ".norm" in key:
            out[key] = (1.0, 0.0) if leaf == "weight" else (0.0, 0.0)
        elif leaf == "in_proj_weight":
            out[key] = (0.0, math.sqrt(6.0 / (shape[1] + shape[0])))
        elif leaf == "in_proj_bias":
            out[key] = (0.0, 0.0)
        elif name == "lm" and key.startswith("posit_embedding"):
            out[key] = (0.0, math.sqrt(6.0 / (shape[0] + shape[1])))
        elif "embedding" in key:
            out[key] = (0.0, SQRT3)
        elif key.startswith(("encoder.", "decoder.")):
            hidden = shape[0] // 4
            out[key] = (0.0, 1.0 / math.sqrt(hidden))
        else:  # a linear or convolution weight or bias: its fan-in
            weight = (module.state_dict()[key.rsplit(".", 1)[0] + ".weight"]
                      if leaf == "bias" else t)
            out[key] = (0.0, 1.0 / math.sqrt(weight[0].numel()))
    return out
