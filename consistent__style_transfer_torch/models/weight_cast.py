"""One cast of a model's float32 master weights to the compute dtype a call,
with each weight's gradient summed in float32.

Under ``torch.autocast`` every product of a float32 weight casts the weight
to the autocast dtype. Inside a CUDA-graph capture autocast caches no cast,
so a decode of L steps casts each weight L times, and autograd casts each
step's weight gradient back. :class:`WeightCast` casts each weight once,
inside the caller's step (so a captured graph recasts the updated masters at
every replay), and :class:`Uses` hands the copy to the products of one pass
over a sequence (one product a timestep):

- forward: each product takes exactly the values autocast gives it (the
  input cast to the compute dtype where it is not in it already, the one
  copy of the weight and bias), so its output is bit-identical;
- backward: a product returns its input's gradient as autograd would, and
  keeps its output's gradient. When the last product of the pass has run
  its backward, the pass's weight gradient is one product over the stacked
  steps with a float32 result (``aten::mm.dtype`` on the card; a product of
  the operands upcast to float32 on the CPU), and the bias gradient a
  float32 sum; both go to the float32 master. Autograd then sums the passes'
  gradients in float32. No gradient of a weight is summed, or rounded, in
  the compute dtype.

Without a cast (float32, parameters already in the compute dtype) a
:class:`Uses` is the plain product of the weight itself.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import count_step


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two matrices in a low-precision dtype, summed and returned in
    float32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class WeightCast:
    """One copy of each of ``params`` in ``dtype``, made now; records
    ``len(params)`` on the counter ``counter`` (``count_step``, so a graph
    replays the count). The weights must not change while it is in use."""

    def __init__(self, params, dtype: torch.dtype, counter: str):
        self.dtype = dtype
        self.copies = {id(p): p.detach().to(dtype) for p in params}
        count_step(counter, len(self.copies))

    def __getitem__(self, p: torch.Tensor | None) -> torch.Tensor | None:
        return None if p is None else self.copies[id(p)]


class Uses:
    """The products of ``weight`` (and ``bias``) in one pass:
    ``uses(x)`` is ``F.linear(x, weight, bias)``, or ``x @ weight`` for a
    ``transposed`` weight (an embedding table, (in, out)). With a ``cast``
    (:class:`WeightCast`) the products read its copies, and where a gradient
    flows to ``weight`` they are :class:`_Use` nodes whose weight and bias
    gradients :class:`_Gather` forms over the stacked steps."""

    def __init__(self, weight, bias=None, transposed: bool = False,
                 cast: WeightCast | None = None):
        self.transposed = transposed
        self.token = None
        if cast is None:
            self.w, self.b = weight, bias
            return
        self.w, self.b, self.dtype = cast[weight], cast[bias], cast.dtype
        # (input in the compute dtype, output gradient) of each use whose
        # backward ran, in the order it ran
        self.grads: list[tuple[torch.Tensor, torch.Tensor]] = []
        if torch.is_grad_enabled() and weight.requires_grad:
            self.token = _Gather.apply(weakref.ref(self), weight, bias)

    def product(self, x):
        return x @ self.w if self.transposed else F.linear(x, self.w, self.b)

    def __call__(self, x):
        if self.token is None:
            return self.product(x)
        return _Use.apply(x, self.token, self)

    def gradients(self):
        """(weight gradient, bias gradient or None) in float32 from the uses
        whose backward ran; forgets what the pass kept."""
        if not self.grads:
            return None, None
        X = torch.cat([x.reshape(-1, x.shape[-1]) for x, _ in self.grads])
        dY = torch.cat([dy.reshape(-1, dy.shape[-1]) for _, dy in self.grads])
        self.grads = []
        dw = mm_f32(X.t(), dY) if self.transposed else mm_f32(dY.t(), X)
        db = None if self.b is None else dY.sum(0, dtype=torch.float32)
        return dw, db


class _Gather(torch.autograd.Function):
    """The pass's weight and bias gradients. Its output, an empty token, is
    an input of every :class:`_Use` of the pass, so its backward runs after
    all of theirs."""

    @staticmethod
    def forward(ctx, uses_ref, weight, bias):
        ctx.uses_ref = uses_ref  # weak: the Uses holds the token
        ctx.set_materialize_grads(False)
        return weight.new_empty(0)

    @staticmethod
    @once_differentiable
    def backward(ctx, _):
        uses = ctx.uses_ref()
        dw, db = (None, None) if uses is None else uses.gradients()
        return None, dw, db


class _Use(torch.autograd.Function):
    """One product of a pass: autocast's forward, the input's gradient as
    autograd gives it, the output's gradient kept for :class:`_Gather`."""

    @staticmethod
    def forward(ctx, x, token, uses):
        xc = x.to(uses.dtype)
        ctx.uses, ctx.x_dtype = uses, x.dtype
        ctx.save_for_backward(xc)
        ctx.set_materialize_grads(False)
        return uses.product(xc)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if dy is None:
            return None, None, None
        uses = ctx.uses
        uses.grads.append((ctx.saved_tensors[0], dy))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dy @ uses.w.t() if uses.transposed else dy @ uses.w).to(ctx.x_dtype)
        return dx, None, None
