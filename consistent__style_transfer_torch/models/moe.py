"""A sparse mixture-of-experts FFN with a sigmoid router: the expert layer of
LFM2-8B-A1B (``models/lfm2_moe.py``), each expert a SwiGLU.

Routing (:class:`Router`): scores ``s = sigmoid(W_g x)`` over the experts,
the selection ``top_k(s + expert_bias)``, the gates ``s[sel] / (sum s[sel] +
1e-6)`` (``norm_topk_prob``, routed scaling 1). ``expert_bias`` is a buffer
held at its seeded value (zeros): the published configuration gives no
update rate for its balancing, so nothing updates it, and there is no
auxiliary loss.

Dispatch (:meth:`SparseMoE.forward`) has static shapes and never reads the
device from the host, so a CUDA graph captures it whole:

- the N x k routed rows (a token's copy for each of its k experts) are
  sorted by expert with a stable sort, a fixed N x k of them;
- each expert's end offset in the sorted rows comes from a search of the
  sorted expert ids, on the device;
- the three expert products are grouped products over those offsets
  (:func:`grouped_swiglu`);
- the combine gathers each routed row back to its slot (the inverse
  permutation), weights it by its gate and sums the k slots of a token: a
  sum in a fixed order, with no ``index_add_`` (whose atomics add in no
  fixed order on CUDA).

The gather of the rows takes each token's k copies from an expanded view,
so its backward is a sum over the k slots, not an index add.

In bfloat16 the grouped products are ``torch._grouped_mm`` (on the card
CUTLASS grouped GEMMs for sm_90 that read the offsets on the device,
counted as ``kernel.grouped_swiglu``). On the CPU in float32 they are a
loop over the experts' row ranges, read on the host. On the card the
layer takes bfloat16 alone (``torch._grouped_mm`` would read float32's
offsets on the host, which no graph captures): another dtype raises
TypeError.

Weight gradients: under a cast scope (``models/weight_cast.py``, the
generator's ``one_cast``) the layer's products read the scope's bfloat16
copies of the float32 masters through one :class:`ExpertUses` a scope.
With gradients, each call's backward returns its rows' gradient as
autograd would (two grouped products a weight) and stashes its sorted rows,
their experts' offsets, ``h = silu(w1 x) * w3 x`` and the gradients of
``w1 x``, ``w3 x`` and the output; no call forms a weight gradient. After
the scope's last backward, :class:`_ExpertGather` stacks the stash, sorts
it by expert on the device (a stable sort: static shapes, no host read)
and forms each of ``w1``, ``w3`` and ``w2``'s gradients as one grouped
product over the stacked rows, summed in float32 inside the GEMM and
rounded to bfloat16 once (``torch._grouped_mm`` has no float32 result),
then added to the float32 master. A checkpoint's recomputation stashes
nothing: only the original node's backward does. The counters
``moe.grad_gathers`` (one a layer a gather) and ``moe.grad_rows`` (the
stacked rows) are replayed with a graph. Without gradients, or without a
scope, the products are :func:`grouped_swiglu` of the weights given.

Each layer adds its routed rows per expert to ``load`` (an int64 (E,)
buffer, not in the state dict) on the device at every call, inside a
graph too; readers copy it out after the work they measure. Spans
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` record
eager calls; the counter ``moe.rows`` (routed rows) is replayed with each
graph (``utils/profiling.py::count_step``).
"""

from __future__ import annotations

import contextlib
import math
import weakref

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..utils.profiling import count_step, span
from .weight_cast import product

GATE_EPS = 1e-6


def recomputing() -> bool:
    """Whether this forward runs inside a backward: a checkpoint's
    recomputation (``models/lfm2_moe.py``), which counts nothing again."""
    return torch._C._current_graph_task_id() != -1


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=generator, device=generator.device)
            .mul_(2 * bound).sub_(bound))


class Router(nn.Module):
    """(gates (N, k) float32, experts (N, k) int64) of rows x (N, d)."""

    def __init__(self, d: int, n_experts: int, top_k: int):
        super().__init__()
        self.top_k = top_k
        self.weight = nn.Parameter(torch.empty(n_experts, d))
        self.register_buffer("expert_bias", torch.zeros(n_experts))

    def forward(self, x, cast):
        s = torch.sigmoid(product(x, self.weight, cast).float())
        experts = torch.topk(s + self.expert_bias.float(), self.top_k, dim=-1).indices
        picked = s.gather(-1, experts)
        return picked / (picked.sum(-1, keepdim=True) + GATE_EPS), experts


def _grouped_swiglu_parts(xs, ends, w1, w3, w2):
    """(a = w1 x, b = w3 x, h = silu(a) * b, w2 h) of the sorted bfloat16
    rows, grouped products counted as one ``kernel.grouped_swiglu`` on the
    card."""
    if xs.is_cuda:
        count_step("kernel.grouped_swiglu", 1)
    a = torch._grouped_mm(xs, w1.transpose(1, 2), offs=ends)
    b = torch._grouped_mm(xs, w3.transpose(1, 2), offs=ends)
    h = F.silu(a) * b
    return a, b, h, torch._grouped_mm(h, w2.transpose(1, 2), offs=ends)


def grouped_swiglu(xs, ends, w1, w3, w2):
    """``w2_e(silu(w1_e x) * w3_e x)`` of each sorted row x of ``xs`` (R,
    d) with the expert e whose rows end at ``ends[e]`` (int32, (E,),
    ascending): (R, d). ``w1``, ``w3`` (E, F, d), ``w2`` (E, d, F), in xs'
    dtype."""
    if xs.dtype == torch.bfloat16:
        return _grouped_swiglu_parts(xs, ends, w1, w3, w2)[-1]
    if xs.is_cuda:
        raise TypeError(f"grouped_swiglu takes bfloat16 on the card, not {xs.dtype}")
    out, start = [], 0
    for e, end in enumerate(ends.tolist()):
        x = xs[start:end]
        out.append(F.linear(F.silu(F.linear(x, w1[e])) * F.linear(x, w3[e]), w2[e]))
        start = end
    return torch.cat(out)


class ExpertUses:
    """One layer's expert products in one cast scope (module note):
    ``uses(xs, ends)`` is :func:`grouped_swiglu` of the scope's copies of
    ``w1``, ``w3``, ``w2``; where a gradient flows to the masters each call
    is an :class:`_ExpertUse`, and :class:`_ExpertGather` forms the
    weights' gradients from ``stash`` once for the scope."""

    def __init__(self, layer: "SparseMoE", cast):
        self.w1, self.w3, self.w2 = cast[layer.w1], cast[layer.w3], cast[layer.w2]
        # (sorted rows, offsets, h, da, db, dy) of each call whose backward ran
        self.stash: list[tuple[torch.Tensor, ...]] = []
        self.token = None
        if torch.is_grad_enabled() and layer.w1.requires_grad:
            self.token = _ExpertGather.apply(weakref.ref(self), layer.w1, layer.w3, layer.w2)

    def __call__(self, xs, ends):
        if self.token is None:
            return grouped_swiglu(xs, ends, self.w1, self.w3, self.w2)
        return _ExpertUse.apply(xs, ends, self.token, self)

    def gradients(self):
        """(w1, w3, w2)'s gradients in float32 from the calls whose backward
        ran, each one grouped product over their stacked rows sorted by
        expert; forgets the stash."""
        if not self.stash:
            return None, None, None
        xs, ends, h, da, db, dy = zip(*self.stash)
        self.stash = []
        experts = torch.cat([torch.searchsorted(e, torch.arange(len(x), device=x.device,
                                                                dtype=e.dtype), right=True)
                             for x, e in zip(xs, ends)])
        order = experts.argsort(stable=True)
        offs = torch.stack(ends).sum(0, dtype=torch.int32)
        X, H, dA, dB, dY = (torch.cat(t)[order] for t in (xs, h, da, db, dy))
        count_step("moe.grad_gathers", 1)
        count_step("moe.grad_rows", len(X))
        return tuple(torch._grouped_mm(g.t(), inp, offs=offs).float()
                     for g, inp in ((dA, X), (dB, X), (dY, H)))


class _ExpertGather(torch.autograd.Function):
    """The scope's expert weight gradients. Its output, an empty token, is
    an input of every :class:`_ExpertUse` of the scope, so its backward
    runs after all of theirs."""

    @staticmethod
    def forward(ctx, uses_ref, w1, w3, w2):
        ctx.uses_ref = uses_ref  # weak: the ExpertUses holds the token
        ctx.set_materialize_grads(False)
        return w1.new_empty(0)

    @staticmethod
    @once_differentiable
    def backward(ctx, _):
        uses = ctx.uses_ref()
        return None, *((None, None, None) if uses is None else uses.gradients())


class _ExpertUse(torch.autograd.Function):
    """One call's grouped products: the forward of :func:`grouped_swiglu`,
    the rows' gradient as autograd gives it, the weights' gradients left to
    :class:`_ExpertGather`."""

    @staticmethod
    def forward(ctx, xs, ends, token, uses):
        a, b, h, y = _grouped_swiglu_parts(xs, ends, uses.w1, uses.w3, uses.w2)
        ctx.uses = uses
        ctx.save_for_backward(xs, ends, a, b, h)
        ctx.set_materialize_grads(False)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        xs, ends, a, b, h = ctx.saved_tensors
        uses = ctx.uses
        dh = torch._grouped_mm(dy, uses.w2, offs=ends)
        da = torch.ops.aten.silu_backward(dh * b, a)
        db = dh * F.silu(a)
        uses.stash.append((xs, ends, h, da, db, dy))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (torch._grouped_mm(da, uses.w1, offs=ends)
                  + torch._grouped_mm(db, uses.w3, offs=ends))
        return dx, None, None, None


class SparseMoE(nn.Module):
    """The routed FFN: ``sum_{e in sel} g_e SwiGLU_e(x)`` over rows (N, d)."""

    def __init__(self, d: int, d_expert: int, n_experts: int, top_k: int):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.router = Router(d, n_experts, top_k)
        self.w1 = nn.Parameter(torch.empty(n_experts, d_expert, d))
        self.w3 = nn.Parameter(torch.empty(n_experts, d_expert, d))
        self.w2 = nn.Parameter(torch.empty(n_experts, d, d_expert))
        self.register_buffer("load", torch.zeros(n_experts, dtype=torch.long), persistent=False)

    @torch.no_grad()
    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """Each expert's products U(+-1/sqrt(fan_in)), as ``nn.Linear``'s
        default bound; the router too; the bias zero."""
        d, f = self.w1.shape[2], self.w1.shape[1]
        for w, fan_in in ((self.router.weight, d), (self.w1, d), (self.w3, d), (self.w2, f)):
            _uniform_(w, 1.0 / math.sqrt(fan_in), generator)
        self.router.expert_bias.zero_()

    def forward(self, x, cast):
        N, d = x.shape
        k = self.top_k
        fresh = not recomputing()

        def timed(name):
            return span(name) if fresh else contextlib.nullcontext()

        dtype = self.w1.dtype if cast is None else cast.dtype
        with timed("moe.route"):
            gates, experts = self.router(x, cast)
        with timed("moe.dispatch"):
            flat = experts.reshape(-1)
            order = flat.argsort(stable=True)  # sorted row r is slot order[r]
            ends = torch.searchsorted(flat[order], torch.arange(
                self.n_experts, device=x.device), right=True).to(torch.int32)
            if fresh:
                self.load += torch.diff(ends, prepend=ends.new_zeros(1)).long()
                count_step("moe.rows", N * k)
            xs = x.to(dtype)[:, None, :].expand(N, k, d).reshape(N * k, d)[order]
        with timed("moe.experts"):
            if cast is None:
                ys = grouped_swiglu(xs, ends, self.w1, self.w3, self.w2)
            else:
                ys = cast.shared(("experts", id(self)), lambda: ExpertUses(self, cast))(xs, ends)
        with timed("moe.combine"):
            inverse = torch.empty_like(order).scatter_(
                0, order, torch.arange(N * k, device=x.device))
            slots = ys[inverse].view(N, k, d)
            return (slots * gates.to(slots.dtype)[..., None]).sum(dim=1)
