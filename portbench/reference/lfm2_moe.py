"""The plain reference of the LFM2-8B-A1B generator
(https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json) and of
the optimize stage's first steps with it: float32 PyTorch, no kernels, no
CUDA graphs, no autocast, no cache, importing nothing of the port. The
parameters carry the port's state-dict names, so one set of seeded
weights loads into both.

The block: ``h += mixer(rms(h))``, ``h += ffn(rms(h))``, then ``rms`` and
a head tied to the token embedding. The conv mixer ``out_proj(c *
conv3(b * x~))`` with ``[b; c; x~] = in_proj(x)`` (depthwise, causal,
zeros before the sequence, no bias); the attention mixer with q/k RMSNorms
over the head dim, RoPE (theta 1e6, rotate-half), GQA and a causal softmax
of the scores over sqrt(head_dim); a SwiGLU FFN in the first
``num_dense_layers`` layers, else ``num_experts`` experts: scores
``s = sigmoid(W_g x)``, the selection ``top_k(s + expert_bias)``, gates
``s[sel] / (sum s[sel] + 1e-6)``, each expert run on the rows routed to it,
one expert after another. Departures, as in the port: a zero
``expert_bias`` that nothing updates and no auxiliary loss; the tied head;
the system's vocabulary; this repository's style conditioning (the source
plus style ``label_i``, a start embedding, then the teacher or the
generated tokens plus style ``label``, causal throughout) and dropout on
the embedded inputs alone, drawn in the port's order.

A decode has no cache: each step runs the full pass over the prefix, and
with gradients it is checkpointed a step (the inputs kept, the pass run
again in the backward), which holds a step's activations at a time.

**The program's path.** A bfloat16 program and this float32 reference
pick different experts for a token whose 4th and 5th scores nearly tie,
and a different expert changes the layer's output outright; and a decode
whose two best logits nearly tie feeds back another token, after which
the rows differ outright. So the reference follows the program's path:
each call takes the program's selection, ``routes`` ((n_moe_layers, B, P,
k) expert ids of every position of the call), and computes its gates from
its own scores at those experts, noting where its own top-k differs
(:class:`Routes`; the flips are a number of their own); and each
straight-through decode feeds back the program's tokens, ``feed`` (B, L),
with the straight-through gradient of its own probabilities. The tokens
a judged step produced are judged by the reference's logits along that
path from the seeded weights, which are the program's too as its judged
steps start (:func:`judge`), and the flips are counted there, at the
same positions.

``fault`` plants a fault for the control runs: ``"top3"`` (each token
routed to the first 3 of its k experts, the gates over those 3),
``"conv_shift"`` (at every decode position after the first, the conv's
two earlier taps read the rows one step further back), ``"half_batch"``
(the first half of the rows alone). ``fp8`` computes every product of the
generator in fp8 (``lowp.fp8``), in the backward's recomputation too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.lowp import fp8
from portbench.reference.models import SQRT3, dropout
from portbench.reference.optimize import Adam, bce_with_logits, cross_entropy

GATE_EPS = 1e-6


def widths(cfg: dict) -> dict:
    """The generator's widths from a configuration file's published keys."""
    return dict(d=cfg["hidden_size"], H=cfg["num_attention_heads"],
                KV=cfg["num_key_value_heads"],
                hd=cfg["hidden_size"] // cfg["num_attention_heads"], ff=cfg["intermediate_size"],
                fe=cfg["moe_intermediate_size"], E=cfg["num_experts"],
                k=cfg["num_experts_per_tok"], n_dense=cfg["num_dense_layers"],
                W=cfg["conv_L_cache"], theta=float(cfg["rope_theta"]), eps=cfg["norm_eps"],
                kinds=tuple(cfg["layer_types"][:cfg["num_hidden_layers"]]))


class _Bag(nn.Module):
    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            if isinstance(part, nn.Module):
                self.add_module(name, part)
            else:
                self.register_parameter(name, nn.Parameter(torch.empty(part)))


def _w(d_out, d_in):
    return _Bag(weight=(d_out, d_in))


class Routes:
    """The program's selections of one generator call, (n_moe, B, P, k)
    ids, and this reference's own top-k at the same positions, ``own``,
    and where they differ, ``flips`` (n_moe, B, P) (each set again, to the
    same value, when a pass is rerun). None: the reference routes alone."""

    def __init__(self, table: torch.Tensor | None):
        self.table = table
        if table is not None:
            self.own = torch.zeros_like(table)
            self.flips = torch.zeros(table.shape[:3], dtype=torch.bool, device=table.device)


def differs(a, b):
    """Where two selections (N, k) hold other experts, as sets."""
    return (a.sort(-1).values != b.sort(-1).values).any(-1)


class Lfm2MoeRef(nn.Module):
    def __init__(self, cfg: dict, n_vocab: int, n_class: int, p_drop: float):
        super().__init__()
        w = self.w = widths(cfg)
        d, H, KV, hd = w["d"], w["H"], w["KV"], w["hd"]
        self.p_drop, self.fault, self.fp8 = p_drop, None, False
        self.token_embedding = _w(n_vocab, d)
        self.style_embedding = _w(n_class, d)
        self.start_embedding = _w(1, d)
        layers = []
        for i, kind in enumerate(w["kinds"]):
            if kind == "conv":
                mixer = _Bag(in_proj=_w(3 * d, d), conv_weight=(d, w["W"]), out_proj=_w(d, d))
            else:
                mixer = _Bag(q_proj=_w(H * hd, d), k_proj=_w(KV * hd, d), v_proj=_w(KV * hd, d),
                             out_proj=_w(d, H * hd), q_layernorm=_Bag(weight=(hd,)),
                             k_layernorm=_Bag(weight=(hd,)))
            if i < w["n_dense"]:
                ffn = _Bag(w1=_w(w["ff"], d), w3=_w(w["ff"], d), w2=_w(d, w["ff"]))
            else:
                router = _Bag(weight=(w["E"], d))
                router.register_buffer("expert_bias", torch.empty(w["E"]))
                ffn = _Bag(router=router, w1=(w["E"], w["fe"], d), w3=(w["E"], w["fe"], d),
                           w2=(w["E"], d, w["fe"]))
            layers.append(_Bag(operator_norm=_Bag(weight=(d,)), ffn_norm=_Bag(weight=(d,)),
                               mixer=mixer, feed_forward=ffn))
        self.layers = nn.ModuleList(layers)
        self.embedding_norm = _Bag(weight=(d,))

    # ---------------------------------------------------------------- parts
    def mm(self, a, b):
        """The product a @ b, in fp8 when ``self.fp8``."""
        if not self.fp8:
            return a @ b
        return fp8(fp8(a) @ fp8(b))

    def rms(self, x, weight):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.w["eps"]) * weight

    def conv(self, m, x, shift_from: int | None):
        """``shift_from``: the first position whose earlier taps read one
        row further back (the ``conv_shift`` fault), or None."""
        P, W = x.shape[1], self.w["W"]
        b, c, xt = self.mm(x, m.in_proj.weight.t()).chunk(3, -1)
        u = F.pad(b * xt, (0, 0, W, 0))  # one more zero row, for the shifted taps
        v = u[:, W:] * m.conv_weight[:, W - 1]
        for j in range(W - 1):
            tap = u[:, j + 1:j + 1 + P]
            if shift_from is not None:
                late = torch.arange(P, device=x.device)[None, :, None] >= shift_from
                tap = torch.where(late, u[:, j:j + P], tap)
            v = v + tap * m.conv_weight[:, j]
        return self.mm(c * v, m.out_proj.weight.t())

    def rope(self, x):
        P, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / self.w["theta"] ** (torch.arange(0, hd, 2, device=x.device,
                                                     dtype=torch.float32) / hd)
        ang = torch.arange(P, device=x.device, dtype=torch.float32)[:, None] * inv
        ang = torch.cat([ang, ang], -1)
        rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], -1)
        return x * ang.cos()[:, None] + rot * ang.sin()[:, None]

    def attention(self, m, x):
        B, P, _ = x.shape
        H, KV, hd = self.w["H"], self.w["KV"], self.w["hd"]
        q = self.rope(self.rms(self.mm(x, m.q_proj.weight.t()).view(B, P, H, hd),
                               m.q_layernorm.weight))
        k = self.rope(self.rms(self.mm(x, m.k_proj.weight.t()).view(B, P, KV, hd),
                               m.k_layernorm.weight))
        v = self.mm(x, m.v_proj.weight.t()).view(B, P, KV, hd)
        k, v = (t.repeat_interleave(H // KV, 2).transpose(1, 2) for t in (k, v))
        scores = self.mm(q.transpose(1, 2), k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(P, P, dtype=torch.bool, device=x.device).tril()
        attn = scores.masked_fill(~causal, float("-inf")).softmax(-1)
        out = self.mm(attn, v).transpose(1, 2).reshape(B, P, H * hd)
        return self.mm(out, m.out_proj.weight.t())

    def experts(self, m, x, given):
        """(the routed FFN of rows x (N, d), the own top-k (N, k)).
        ``given``: the program's selection (N, k), or None to route
        alone."""
        k = self.w["k"]
        s = torch.sigmoid(self.mm(x, m.router.weight.t()))
        own = torch.topk(s + m.router.expert_bias, k, dim=-1).indices
        sel = own if given is None else given
        if self.fault == "top3":
            sel = sel[:, :3]
        picked = s.gather(-1, sel)
        gates = picked / (picked.sum(-1, keepdim=True) + GATE_EPS)
        out = torch.zeros_like(x)
        for e in range(self.w["E"]):
            rows, slot = (sel == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = self.mm(F.silu(self.mm(xe, m.w1[e].t())) * self.mm(xe, m.w3[e].t()),
                         m.w2[e].t())
            out = out.index_put((rows,), gates[rows, slot][:, None] * ye, accumulate=True)
        return out, own

    def logits(self, h, routes: Routes | None = None, shift_from: int | None = None):
        """The full causal pass over embedded inputs h (B, P, d): (B, P, V),
        at positions 0..P-1 of ``routes``' table."""
        B, P, d = h.shape
        moe = 0
        for kind, layer in zip(self.w["kinds"], self.layers):
            x = self.rms(h, layer.operator_norm.weight)
            h = h + (self.conv(layer.mixer, x, shift_from) if kind == "conv" else
                     self.attention(layer.mixer, x))
            x = self.rms(h, layer.ffn_norm.weight).reshape(B * P, d)
            ffn = layer.feed_forward
            if hasattr(ffn, "router"):
                given = None
                if routes is not None and routes.table is not None:
                    given = routes.table[moe, :, :P].reshape(B * P, -1)
                y, own = self.experts(ffn, x, given)
                if given is not None:
                    routes.own[moe, :, :P] = own.view(B, P, -1)
                    routes.flips[moe, :, :P] = differs(own, given).view(B, P)
                moe += 1
            else:
                y = self.mm(F.silu(self.mm(x, ffn.w1.weight.t())) * self.mm(x, ffn.w3.weight.t()),
                            ffn.w2.weight.t())
            h = h + y.view(B, P, d)
        return self.mm(self.rms(h, self.embedding_norm.weight), self.token_embedding.weight.t())

    # ------------------------------------------------------ generator calls
    def _drop(self, t, generator):
        return dropout(t, self.p_drop, self.training, generator)

    def source(self, inp, label_i, generator):
        e = F.embedding(inp.long(), self.token_embedding.weight)
        return self._drop(e + self.style_embedding.weight[label_i.long()][:, None], generator)

    def teacher(self, inp, label_i, x, label, generator=None, routes=None):
        """The teacher-forced pass: logits (B, L, V) of x."""
        src = self.source(inp, label_i, generator)
        B = x.shape[0]
        tgt = torch.cat([self.start_embedding.weight[None].expand(B, 1, -1),
                         F.embedding(x[:, :-1].long(), self.token_embedding.weight)], 1)
        tgt = self._drop(tgt + self.style_embedding.weight[label.long()][:, None], generator)
        return self.logits(torch.cat([src, tgt], 1), routes)[:, src.shape[1]:]

    def st_decode(self, inp, label_i, label, L, tau, generator=None, routes=None, feed=None):
        """The straight-through decode: probs (B, L, V), each step the full
        pass over the prefix (checkpointed when gradients are on), feeding
        back its own argmax, or ``feed`` (B, L) where given."""
        seq = self.source(inp, label_i, generator)
        Ls, B = seq.shape[1], seq.shape[0]
        style = self.style_embedding.weight[label.long()][:, None]
        table = self.token_embedding.weight
        x_t = self.start_embedding.weight[None].expand(B, 1, -1)
        shift = Ls + 1 if self.fault == "conv_shift" else None
        outs = []
        for t in range(L):
            seq = torch.cat([seq, self._drop(x_t + style, generator)], 1)

            def last(s):
                return self.logits(s, routes, shift)[:, -1]

            logits = (checkpoint(last, seq, use_reentrant=False) if torch.is_grad_enabled()
                      else last(seq))
            p = torch.softmax(logits / tau, -1)
            ids = p.argmax(-1) if feed is None else feed[:, t].long()
            hard = torch.zeros_like(p).scatter_(-1, ids[:, None], 1.0)
            x_t = self.mm(hard - p.detach() + p, table)[:, None]
            outs.append(p)
        return torch.stack(outs, 1)

    def forced_st_logits(self, inp, label_i, label, feed, generator=None, routes=None):
        """Logits (B, L, V) of each step of the straight-through decode when
        each step feeds back ``feed`` (B, L): one teacher-forced pass along
        the program's tokens, with the decode's dropout draws in its order
        (the source block, then a row a step)."""
        src = self.source(inp, label_i, generator)
        B, L = feed.shape
        style = self.style_embedding.weight[label.long()][:, None]
        rows = [self.start_embedding.weight[None].expand(B, 1, -1)] + [
            F.embedding(feed[:, t:t + 1].long(), self.token_embedding.weight)
            for t in range(L - 1)]
        tgt = torch.cat([self._drop(r + style, generator) for r in rows], 1)
        shift = src.shape[1] + 1 if self.fault == "conv_shift" else None
        return self.logits(torch.cat([src, tgt], 1), routes, shift)[:, src.shape[1]:]


# ------------------------------------------------------------- the weights
def build(cfg: dict, n_vocab: int, device) -> Lfm2MoeRef:
    with torch.device(device):
        return Lfm2MoeRef(cfg, n_vocab, cfg["n_class"], cfg["generator"]["p_drop"])


def init_bounds(module: Lfm2MoeRef) -> dict[str, tuple[float, float]]:
    """(centre, half-width) of each state-dict key's uniform draw: the
    embeddings N(0, 0.02^2) as the uniform of that deviation; norms 1;
    ``expert_bias`` 0; the convolution U(+-1/sqrt(width)); every other
    product U(+-1/sqrt(fan_in))."""
    out = {}
    for key, t in module.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if "embedding" in key and "norm" not in key:
            out[key] = (0.0, SQRT3 * 0.02)
        elif "norm" in key:
            out[key] = (1.0, 0.0)
        elif leaf == "expert_bias":
            out[key] = (0.0, 0.0)
        else:
            out[key] = (0.0, 1.0 / math.sqrt(t.shape[-1]))
    return out


def seeded_state(cfg: dict, n_vocab: int, seed: int, device) -> dict:
    """The generator's seeded state dict on ``device``: one generator on the
    device, a uniform draw a tensor in state-dict order, scaled to
    :func:`init_bounds`."""
    meta = build(cfg, n_vocab, "meta")
    bounds = init_bounds(meta)
    gen = torch.Generator(device).manual_seed((seed * 1_000_003 + 7919 * 6) % 2**63)
    state = {}
    for key, t in meta.state_dict().items():
        centre, half = bounds[key]
        u = torch.rand(t.shape, generator=gen, device=device)
        state[key] = u.mul_(2.0 * half).add_(centre - half)
    return state


# ------------------------------------------------------ the optimize steps
def _half(x, labels, fault):
    if fault == "half_batch":
        return x[: x.shape[0] // 2], labels[: labels.shape[0] // 2]
    return x, labels


def g_loss(m: dict, cfg: dict, x, labels, generator, routes: dict, feed: dict):
    """The G step's loss (batch-major, no sched coins: the port's rule for
    a backbone other than the LSTM) along the program's tokens ``feed``,
    and the ids its own transfer chooses along them."""
    G, CLS, MAT, D = m["generator"], m["classifier"], m["matcher"], m["disc"]
    for mod in (G, CLS, MAT):
        mod.train()
    D.eval()
    o = cfg["optimize"]
    sample_p = G.st_decode(x, labels, 1 - labels, x.shape[1], o["tau"], generator,
                           routes["g_st"], feed["g_st"])
    s_logits = CLS(sample_p, generator)
    c_logits = MAT(sample_p, x, generator)
    adv_logits = D(sample_p)
    bk_logits = G.teacher(feed["g_st"], 1 - labels, x, labels, generator, routes["g_bt"])
    s_loss = cross_entropy(s_logits, 1 - labels)
    c_loss = ((c_logits.float() - o["gap"]) ** 2).mean()
    adv_loss = bce_with_logits(adv_logits, torch.ones_like(adv_logits))
    bk_loss = cross_entropy(bk_logits.reshape(-1, bk_logits.shape[-1]), x.reshape(-1))
    total = o["w_bt"] * bk_loss + o["w_c"] * c_loss + o["w_adv"] * adv_loss + o["w_s"] * s_loss
    return total, sample_p.detach().argmax(-1)


def d_loss(m: dict, cfg: dict, x, labels, d_generator, routes: dict, feed: dict):
    G, D = m["generator"], m["disc"]
    G.train()
    with torch.no_grad():
        fake_p = G.st_decode(x, labels, 1 - labels, x.shape[1], cfg["optimize"]["tau"],
                             d_generator, routes["d_st"], feed["d_st"])
    D.train()
    t_logits = D(x, d_generator)
    f_logits = D(fake_p, d_generator)
    loss = 0.5 * (bce_with_logits(t_logits, torch.ones_like(t_logits))
                  + bce_with_logits(f_logits, torch.zeros_like(f_logits)))
    return cfg["optimize"]["w_adv"] * loss


def first_steps(m: dict, cfg: dict, batches, routes, feeds, generator, d_generator,
                fault: str | None = None, sound: bool = False):
    """The optimize loop's first ``len(batches)`` steps from the loaded
    weights along the program's path: each generator call takes the
    program's selection (``routes``: per step {"g_st", "g_bt", "d_st"}
    tables), each decode feeds back the program's tokens (``feeds``: per
    step {"g_st", "d_st"} ids). Returns {"losses", "params" (every leaf
    after the last step: the modules' own tensors)}; with ``sound`` also
    "keep" (the elements whose first gradient is above round-off:
    ``compare.moving``). Everything stays on the device."""
    from portbench.reference.compare import moving

    G, D = m["generator"], m["disc"]
    G.fault = fault
    for name in ("classifier", "matcher", "lm"):
        m[name].requires_grad_(False)
    o = cfg["optimize"]
    g_named, d_named = list(G.named_parameters()), list(D.named_parameters())
    g_opt = Adam([p for _, p in g_named], o["lr"], o["clip"])
    d_opt = Adam([p for _, p in d_named], o["lr"], o["clip"])
    acc = [torch.zeros_like(p) for _, p in d_named]
    losses, first = [], {}
    for i, (x, labels) in enumerate(batches):
        x, labels = _half(x, labels, fault)
        step = {key: Routes(None if t is None else t[:, :x.shape[0]])
                for key, t in routes[i].items()}
        feed = {key: t[:x.shape[0]] for key, t in feeds[i].items()}
        total, _ = g_loss(m, cfg, x, labels, generator, step, feed)
        g_grads = g_opt.step(torch.autograd.grad(total, g_opt.params))
        dl = d_loss(m, cfg, x, labels, d_generator, step, feed)
        d_grads = torch.autograd.grad(dl, d_opt.params)
        torch._foreach_add_(acc, d_grads)
        if i % o["d_update_every"] == 0:
            applied = d_opt.step(acc)
            acc = [torch.zeros_like(p) for p in acc]
            if i == 0 and sound:
                first.update({f"disc.{k}": g for (k, _), g in zip(d_named, applied)})
        if i == 0 and sound:
            first.update({f"generator.{k}": g for (k, _), g in zip(g_named, g_grads)})
            first = moving(first)
        del g_grads, d_grads
        losses.append((float(total.detach()), float(dl.detach())))
    G.fault = None
    params = {f"generator.{k}": p.detach() for k, p in g_named}
    params.update({f"disc.{k}": p.detach() for k, p in d_named})
    out = {"losses": losses, "params": params}
    if sound:
        out["keep"] = first
    return out


@torch.no_grad()
def path_logits(G: Lfm2MoeRef, x, labels, feed, state, table):
    """(The reference's logits (B, L, V) at each step of a step's
    straight-through transfer along the program's path, its
    :class:`Routes` there): fed the program's tokens ``feed`` (B, L),
    taking that decode's selection ``table``, from G's weights as they are
    and the dropout draws of a generator in ``state``."""
    generator = torch.Generator(x.device)
    generator.set_state(state)
    G.train()
    routes = Routes(table)
    return G.forced_st_logits(x, labels, 1 - labels, feed, generator, routes), routes


def judge(G: Lfm2MoeRef, steps: dict, fault: str | None = None, fp8: bool = False) -> dict:
    """G's transfers at the judged steps along the program's path, from
    G's weights as they are (the seeded ones): ``steps`` {step: (x,
    labels, the fed-back ids, the decode's selection table, the dropout
    generator's state as the step starts)}. Returns {step: (logits (b, L,
    V), own top-k (n_moe, b, 2L, k))}, b the rows the fault keeps."""
    G.fault, G.fp8 = fault, fp8
    out = {}
    for i, (x, labels, feed, table, state) in steps.items():
        x, labels = _half(x, labels, fault)
        b = x.shape[0]
        logits, routes = path_logits(G, x, labels, feed[:b], state, table[:, :b])
        out[i] = (logits.clone(), routes.own)
        del logits, routes
    G.fault, G.fp8 = None, False
    return out
