"""A plain float32 reference of the LFM2-8B-A1B generator
(``consistent__style_transfer_torch/models/lfm2_moe.py``) for the port's
CPU tests: plain ``torch``, importing neither package nor any kernel of
the port, in the port's state-dict names so one set of weights loads into
both.

Equations (https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json):
``h += mixer(rms(h))``, ``h += ffn(rms(h))``; the conv mixer ``out_proj(c *
conv3(b * x~))`` with ``[b; c; x~] = in_proj(x)``; the attention mixer
with q/k RMSNorms, RoPE (rotate-half), GQA and a causal softmax over
sqrt(head_dim); a SwiGLU FFN in the first ``n_dense`` layers, else the
sigmoid-routed top-k experts, ``g = s[sel] / (sum s[sel] + 1e-6)``, each
expert run on the rows routed to it, one expert after another; the final
RMSNorm and the head tied to the token embedding. The same departures as
the port's module: a zero ``expert_bias`` never updated, a tied head, the
repository's style conditioning (source + style ``label_i``, a start
embedding, then the teacher or the generated tokens + style ``label``)
and dropout on the embedded inputs alone, drawn as the port draws it.

No cache: :meth:`PlainLfm2Moe.decode` recomputes the whole prefix at every
step, so each step's logits are those of the full forward pass over the
tokens fed so far.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYER_TYPES = ("conv", "conv", "full_attention", "conv", "conv", "conv", "full_attention",
               "conv")


def dropout(x, p: float, training: bool, generator):
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def rms(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (B, P, h, hd) at positions 0..P-1, rotate-half."""
    P, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    ang = torch.arange(P, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], -1)
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], -1)
    return x * ang.cos()[:, None] + rot * ang.sin()[:, None]


class _Holder(nn.Module):
    """A bag of parameters under given names."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            if isinstance(shape, nn.Module):
                self.add_module(name, shape)
            else:
                self.register_parameter(name, nn.Parameter(torch.zeros(shape)))


def _lin(d_in, d_out):
    return _Holder(weight=(d_out, d_in))


class PlainLfm2Moe(nn.Module):
    def __init__(self, n_vocab, n_class, n_layers, d, n_heads, n_kv, head_dim, d_ff, d_expert,
                 n_experts, top_k, n_dense, p_drop=0.0, eps=1e-5, theta=1e6, width=3):
        super().__init__()
        self.cfg = dict(d=d, H=n_heads, KV=n_kv, hd=head_dim, E=n_experts, k=top_k, eps=eps,
                        theta=theta, W=width)
        self.p_drop = p_drop
        self.token_embedding = _Holder(weight=(n_vocab, d))
        self.style_embedding = _Holder(weight=(n_class, d))
        self.start_embedding = _Holder(weight=(1, d))
        self.kinds = LAYER_TYPES[:n_layers]
        layers = []
        for i, kind in enumerate(self.kinds):
            if kind == "conv":
                mixer = _Holder(in_proj=_lin(d, 3 * d), conv_weight=(d, width),
                                out_proj=_lin(d, d))
            else:
                mixer = _Holder(q_proj=_lin(d, n_heads * head_dim),
                                k_proj=_lin(d, n_kv * head_dim), v_proj=_lin(d, n_kv * head_dim),
                                out_proj=_lin(n_heads * head_dim, d),
                                q_layernorm=_Holder(weight=(head_dim,)),
                                k_layernorm=_Holder(weight=(head_dim,)))
            if i < n_dense:
                ffn = _Holder(w1=_lin(d, d_ff), w3=_lin(d, d_ff), w2=_lin(d_ff, d))
            else:
                router = _Holder(weight=(n_experts, d))
                router.register_buffer("expert_bias", torch.zeros(n_experts))
                ffn = _Holder(router=router, w1=(n_experts, d_expert, d),
                              w3=(n_experts, d_expert, d), w2=(n_experts, d, d_expert))
            layers.append(_Holder(operator_norm=_Holder(weight=(d,)),
                                  ffn_norm=_Holder(weight=(d,)), mixer=mixer, feed_forward=ffn))
        self.layers = nn.ModuleList(layers)
        self.embedding_norm = _Holder(weight=(d,))

    # ---- one layer's parts over a whole sequence (B, P, d)
    def conv(self, m, x):
        P = x.shape[1]
        b, c, xt = (x @ m.in_proj.weight.t()).chunk(3, -1)
        u = F.pad(b * xt, (0, 0, self.cfg["W"] - 1, 0))
        v = sum(u[:, j:j + P] * m.conv_weight[:, j] for j in range(self.cfg["W"]))
        return (c * v) @ m.out_proj.weight.t()

    def attention(self, m, x):
        B, P, _ = x.shape
        c = self.cfg
        q = rms((x @ m.q_proj.weight.t()).view(B, P, c["H"], c["hd"]), m.q_layernorm.weight,
                c["eps"])
        k = rms((x @ m.k_proj.weight.t()).view(B, P, c["KV"], c["hd"]), m.k_layernorm.weight,
                c["eps"])
        v = (x @ m.v_proj.weight.t()).view(B, P, c["KV"], c["hd"])
        q, k = rope(q, c["theta"]), rope(k, c["theta"])
        rep = c["H"] // c["KV"]
        k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(c["hd"])
        causal = torch.ones(P, P, dtype=torch.bool).tril()
        attn = scores.masked_fill(~causal, float("-inf")).softmax(-1)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, P, -1) @ m.out_proj.weight.t()

    def route(self, m, x):
        """(gates (N, k), experts (N, k)) of rows x (N, d)."""
        s = torch.sigmoid(x @ m.router.weight.t())
        experts = torch.topk(s + m.router.expert_bias, self.cfg["k"], dim=-1).indices
        picked = s.gather(-1, experts)
        return picked / (picked.sum(-1, keepdim=True) + 1e-6), experts

    def experts(self, m, x):
        """The routed FFN of rows x (N, d): each expert on its own rows."""
        gates, experts = self.route(m, x)
        out = torch.zeros_like(x)
        for e in range(self.cfg["E"]):
            rows, slot = (experts == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = (F.silu(xe @ m.w1[e].t()) * (xe @ m.w3[e].t())) @ m.w2[e].t()
            out = out.index_put((rows,), gates[rows, slot][:, None] * ye, accumulate=True)
        return out

    def ffn(self, m, x):
        B, P, d = x.shape
        x = x.reshape(B * P, d)
        if hasattr(m, "router"):
            return self.experts(m, x).view(B, P, d)
        return ((F.silu(x @ m.w1.weight.t()) * (x @ m.w3.weight.t())) @ m.w2.weight.t()).view(
            B, P, d)

    def logits(self, h):
        """The full causal pass over embedded inputs h (B, P, d): (B, P, V)."""
        eps = self.cfg["eps"]
        for kind, layer in zip(self.kinds, self.layers):
            x = rms(h, layer.operator_norm.weight, eps)
            h = h + (self.conv(layer.mixer, x) if kind == "conv" else
                     self.attention(layer.mixer, x))
            h = h + self.ffn(layer.feed_forward, rms(h, layer.ffn_norm.weight, eps))
        return rms(h, self.embedding_norm.weight, eps) @ self.token_embedding.weight.t()

    # ---- the generator's calls
    def _source(self, inp, label_i, generator):
        e = self.token_embedding.weight[inp.long()] + self.style_embedding.weight[label_i][:, None]
        return dropout(e, self.p_drop, self.training, generator)

    def forward(self, inp, label_i, x, label, generator=None):
        """Teacher-forced logits (B, L, V) of x."""
        src = self._source(inp, label_i, generator)
        B = x.shape[0]
        tgt = torch.cat([self.start_embedding.weight[None].expand(B, 1, -1),
                         self.token_embedding.weight[x[:, :-1].long()]], 1)
        tgt = dropout(tgt + self.style_embedding.weight[label][:, None], self.p_drop,
                      self.training, generator)
        return self.logits(torch.cat([src, tgt], 1))[:, src.shape[1]:]

    def decode(self, inp, label_i, label, L, mode="greedy", tau=1.0, generator=None):
        """Each step the full pass over the prefix: ids (B, L) for greedy,
        probs (B, L, V) for st (straight-through), logits for sched."""
        seq = self._source(inp, label_i, generator)
        B = inp.shape[0]
        style = self.style_embedding.weight[label][:, None]
        table = self.token_embedding.weight
        x_t = self.start_embedding.weight[None].expand(B, 1, -1)
        outs = []
        for _ in range(L):
            seq = torch.cat([seq, dropout(x_t + style, self.p_drop, self.training, generator)], 1)
            logits = self.logits(seq)[:, -1]
            if mode == "st":
                p = torch.softmax(logits / tau, -1)
                hard = torch.zeros_like(p).scatter_(-1, p.argmax(-1, keepdim=True), 1.0)
                out, x_t = p, ((hard - p.detach() + p) @ table)[:, None]
            else:
                ids = logits.argmax(-1)
                out, x_t = (ids if mode == "greedy" else logits), table[ids][:, None]
            outs.append(out)
        return torch.stack(outs, 1)
