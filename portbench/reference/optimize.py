"""The plain reference of the optimize stage's first steps and its
validation loss (``src/main_optimize.py:78-141``), in float32 with no
graphs, kernels or autocast.

Per batch: G's update (the straight-through transfer scored by the frozen
classifier and matcher in train mode and by D in eval mode, plus the
back-translation CE through a scheduled-sampling decode), then D's
gradients on a fresh no-grad transfer in train mode, summed into an
accumulator that is applied, clipped as a sum, at every ``d_update_every``-th
batch. Both optimizers are Adam(lr, 0.9, 0.999, 1e-8) behind a clip of the
global norm that acts when the norm is at least the clip. Soft decodes stay
time-major (L, B, V) and every consumer projects before it transposes, as
the port does, so the dropout masks have the port's shapes and order.

``fault`` plants one of the faults the benchmark's control runs read: the
``"half_batch"`` step (the first half of the rows alone, decoded and
averaged), the ``"half_loss"`` step (every row decoded, each loss averaged
over the first half of the rows), the ``"token"`` step (each
straight-through decode feeds back, in its first row, the token after the
one it produced).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BETAS, EPS = (0.9, 0.999), 1e-8


def _next_token_in_row0(hard):
    return torch.cat([hard[:1].roll(1, dims=-1), hard[1:]])


ALTER = {"token": _next_token_in_row0}


def cross_entropy(logits, labels, mask=None):
    nll = -F.log_softmax(logits.float(), dim=-1).gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def bce_with_logits(z, t):
    z = z.float()
    return (torch.clamp_min(z, 0.0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()


class Adam:
    """Adam behind the clip of the global norm (optax's rule: at a norm of at
    least ``clip`` every gradient becomes g / norm * clip)."""

    def __init__(self, params, lr: float, clip: float):
        self.params, self.lr, self.clip, self.t = list(params), lr, clip, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def clipped(self, grads):
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = torch.where(norm >= self.clip, self.clip / norm, torch.ones_like(norm))
        return [g * scale for g in grads]

    @torch.no_grad()
    def step(self, grads):
        """Apply ``grads``; returns them as clipped."""
        grads = self.clipped(grads)
        self.t += 1
        c1, c2 = 1 - BETAS[0] ** self.t, 1 - BETAS[1] ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
            v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(EPS), value=-self.lr / c1)
        return grads


def _head_rows(t, fault: str | None, batch: int, dim: int = 0):
    """``t`` whole, or with ``"half_loss"`` its first half of the rows along
    ``dim`` (a D's output holds ``num_rep`` rows per sentence, in order)."""
    if fault != "half_loss":
        return t
    return t.narrow(dim, 0, t.shape[dim] // batch * (batch // 2))


def g_loss(m: dict, cfg: dict, x, labels, generator, fault: str | None = None):
    G, CLS, MAT, D = m["generator"], m["classifier"], m["matcher"], m["disc"]
    for mod in (G, CLS, MAT):
        mod.train()
    D.eval()
    if fault == "half_batch":
        x, labels = x[: x.shape[0] // 2], labels[: labels.shape[0] // 2]
    coins = torch.rand(x.shape[1], generator=generator, device=x.device) < 0.5
    o = cfg["optimize"]
    sample_p = G(x, labels, None, 1 - labels, mode="st", tau=o["tau"], time_major_out=True,
                 generator=generator, alter=ALTER.get(fault))
    s_logits = CLS(sample_p, generator, time_major=True)
    c_logits = MAT(sample_p, x, generator, time_major=True)
    adv_logits = D(sample_p, time_major=True)
    bk_inp = sample_p.detach().argmax(dim=-1).t()
    bk_logits = G(bk_inp, 1 - labels, x, labels, mode="sched", time_major_out=True,
                  generator=generator, coins=coins)
    B = x.shape[0]
    s_logits, c_logits, adv_logits = (_head_rows(t, fault, B) for t in (s_logits, c_logits,
                                                                         adv_logits))
    bk_logits, target = _head_rows(bk_logits, fault, B, 1), _head_rows(x.t(), fault, B, 1)
    s_loss = cross_entropy(s_logits, _head_rows(1 - labels, fault, B))
    c_loss = ((c_logits.float() - o["gap"]) ** 2).mean()
    adv_loss = bce_with_logits(adv_logits, torch.ones_like(adv_logits))
    bk_loss = cross_entropy(bk_logits.reshape(-1, bk_logits.shape[-1]), target.reshape(-1))
    total = o["w_bt"] * bk_loss + o["w_c"] * c_loss + o["w_adv"] * adv_loss + o["w_s"] * s_loss
    return total, bk_inp


def d_loss(m: dict, cfg: dict, x, labels, d_generator, fault: str | None = None):
    G, D = m["generator"], m["disc"]
    if fault == "half_batch":
        x, labels = x[: x.shape[0] // 2], labels[: labels.shape[0] // 2]
    G.train()
    with torch.no_grad():
        fake_p = G(x, labels, None, 1 - labels, mode="st", tau=cfg["optimize"]["tau"],
                   time_major_out=True, generator=d_generator, alter=ALTER.get(fault))
    D.train()
    t_logits = _head_rows(D(x, d_generator), fault, x.shape[0])
    f_logits = _head_rows(D(fake_p, d_generator, time_major=True), fault, x.shape[0])
    loss = 0.5 * (bce_with_logits(t_logits, torch.ones_like(t_logits))
                  + bce_with_logits(f_logits, torch.zeros_like(f_logits)))
    return cfg["optimize"]["w_adv"] * loss


def first_steps(m: dict, cfg: dict, batches, generator, d_generator, fault: str | None = None,
                judged=()):
    """The optimize loop's first ``len(batches)`` steps from the loaded
    weights. Returns {"losses": [(G loss, D loss) per step], "grads": the
    first step's clipped gradient per leaf ("generator.<key>" and
    "disc.<key>"), "params": every leaf after the last step, "tokens": {i: the
    ids (B, L) step i's transfer produced} and "at": {i: (G's weights,
    the generator's state) as step i starts}, for each step i of
    ``judged``}."""
    G, D = m["generator"], m["disc"]
    for name in ("classifier", "matcher", "lm"):
        m[name].requires_grad_(False)
    o = cfg["optimize"]
    g_named, d_named = list(G.named_parameters()), list(D.named_parameters())
    g_opt = Adam([p for _, p in g_named], o["lr"], o["clip"])
    d_opt = Adam([p for _, p in d_named], o["lr"], o["clip"])
    acc = [torch.zeros_like(p) for _, p in d_named]
    losses, first, tokens, at = [], {}, {}, {}
    for i, (x, labels) in enumerate(batches):
        if i in judged:
            at[i] = ({k: v.detach().clone() for k, v in G.state_dict().items()},
                     generator.get_state())
        total, tokens[i] = g_loss(m, cfg, x, labels, generator, fault)
        g_grads = g_opt.step(torch.autograd.grad(total, g_opt.params))
        dl = d_loss(m, cfg, x, labels, d_generator, fault)
        d_grads = torch.autograd.grad(dl, d_opt.params)
        torch._foreach_add_(acc, d_grads)
        if i % o["d_update_every"] == 0:
            applied = d_opt.step(acc)
            acc = [torch.zeros_like(p) for p in acc]
            if i == 0:
                first.update({f"disc.{k}": g for (k, _), g in zip(d_named, applied)})
        if i == 0:
            first.update({f"generator.{k}": g for (k, _), g in zip(g_named, g_grads)})
        losses.append((float(total.detach()), float(dl.detach())))
    params = {f"generator.{k}": p.detach().clone() for k, p in g_named}
    params.update({f"disc.{k}": p.detach().clone() for k, p in d_named})
    return {"losses": losses, "grads": first, "params": params,
            "tokens": {i: tokens[i] for i in judged}, "at": at}


@torch.no_grad()
def token_gap(m: dict, cfg: dict, x, labels, tokens, at) -> float:
    """The widest gap below the reference's best logit of the tokens a
    step's straight-through transfer produced, ``tokens`` (B, L), with the
    reference fed along them from its weights and dropout draws as that
    step starts, ``at`` (G's weights, the generator's state; from
    :func:`first_steps`)."""
    from portbench.reference.compare import logit_gap
    from portbench.reference.models import forced_st_logits

    weights, state = at
    m["generator"].load_state_dict(weights, strict=True)
    generator = torch.Generator(x.device)
    generator.set_state(state)
    m["generator"].train()
    x, labels = x[: tokens.shape[0]], labels[: tokens.shape[0]]  # a step that saw fewer rows
    torch.rand(x.shape[1], generator=generator, device=x.device)  # the step's coins come first
    logits = forced_st_logits(m["generator"], x, labels, 1 - labels, tokens, generator)
    return logit_gap(logits, tokens)


@torch.no_grad()
def validation_terms(m: dict, cfg: dict, x, labels, rows):
    """One dev batch's loss over its real rows ``rows`` (B,): CE of the
    classifier on the ids of the transfer to the target style, plus the
    LM's token CE of those ids, plus the matcher's mean score."""
    G, CLS, MAT, NT = m["generator"], m["classifier"], m["matcher"], m["lm"]
    for mod in (G, CLS, MAT, NT):
        mod.eval()
    tokens = G(x, labels, None, 1 - labels, mode="st", tau=cfg["optimize"]["tau"]).argmax(-1)
    s = cross_entropy(CLS(tokens), 1 - labels, mask=rows)
    logits = NT(tokens)
    mask = rows[:, None].expand(tokens.shape).reshape(-1)
    nt = cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1), mask=mask)
    return s + nt + (MAT(tokens, x).float() * rows).sum() / torch.clamp_min(rows.sum(), 1.0)


def validation_loss(m: dict, cfg: dict, dev_batches) -> float:
    """The validation loss: each dev batch's (x, labels, row_mask) loss
    weighted by its real rows."""
    total, weight = 0.0, 0.0
    for x, labels, rows in dev_batches:
        real = float(rows.sum())
        total += float(validation_terms(m, cfg, x, labels, rows)) * real
        weight += real
    return total / weight
