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
counted in ``grouped_swiglu.launches``). On the CPU in float32 they are a
loop over the experts' row ranges, read on the host. On the card the
layer takes bfloat16 alone (``torch._grouped_mm`` would read float32's
offsets on the host, which no graph captures): another dtype raises
TypeError.

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

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import count_launch
from ..utils.profiling import count_step, span

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
        s = torch.sigmoid(F.linear(x.to(cast.dtype), cast(self.weight)).float())
        experts = torch.topk(s + self.expert_bias.float(), self.top_k, dim=-1).indices
        picked = s.gather(-1, experts)
        return picked / (picked.sum(-1, keepdim=True) + GATE_EPS), experts


def grouped_swiglu(xs, ends, w1, w3, w2):
    """``w2_e(silu(w1_e x) * w3_e x)`` of each sorted row x of ``xs`` (R,
    d) with the expert e whose rows end at ``ends[e]`` (int32, (E,),
    ascending): (R, d). ``w1``, ``w3`` (E, F, d), ``w2`` (E, d, F), in xs'
    dtype."""
    if xs.dtype == torch.bfloat16:
        if xs.is_cuda:
            count_launch(grouped_swiglu)
        a = torch._grouped_mm(xs, w1.transpose(1, 2), offs=ends)
        b = torch._grouped_mm(xs, w3.transpose(1, 2), offs=ends)
        return torch._grouped_mm(F.silu(a) * b, w2.transpose(1, 2), offs=ends)
    if xs.is_cuda:
        raise TypeError(f"grouped_swiglu takes bfloat16 on the card, not {xs.dtype}")
    out, start = [], 0
    for e, end in enumerate(ends.tolist()):
        x = xs[start:end]
        out.append(F.linear(F.silu(F.linear(x, w1[e])) * F.linear(x, w3[e]), w2[e]))
        start = end
    return torch.cat(out)


grouped_swiglu.launches = grouped_swiglu.captured = 0


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
            xs = x.to(cast.dtype)[:, None, :].expand(N, k, d).reshape(N * k, d)[order]
        with timed("moe.experts"):
            ys = grouped_swiglu(xs, ends, cast(self.w1), cast(self.w3), cast(self.w2))
        with timed("moe.combine"):
            inverse = torch.empty_like(order).scatter_(
                0, order, torch.arange(N * k, device=x.device))
            slots = ys[inverse].view(N, k, d)
            return (slots * gates.to(slots.dtype)[..., None]).sum(dim=1)
