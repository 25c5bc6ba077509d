"""The control of the checks: the reference computed in the precision just
below the one the configuration states. For bf16 autocast, whose products
take and give bf16, that is fp8: the factors of every product rounded to
float8 e4m3 with one scale a tensor (its largest magnitude at 448, e4m3's
largest value), the product accumulated in float32, as fp8 tensor cores do,
and its result rounded to e4m3 the same way. The rounding passes gradients
straight through."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    if not torch.is_floating_point(t):
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach()) if t.requires_grad else q


PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch._C.TensorBase.matmul, torch.Tensor.matmul,
            torch.bmm, torch.Tensor.bmm, torch.mm, torch.Tensor.mm, F.linear}


class Fp8Products(TorchFunctionMode):
    """Within this mode every product's inputs go through :func:`fp8`."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func not in PRODUCTS:
            return func(*args, **(kwargs or {}))
        # the two factors; a linear's bias is added to the product, not multiplied
        args = tuple(fp8(a) if i < 2 and isinstance(a, torch.Tensor) else a
                     for i, a in enumerate(args))
        return fp8(func(*args, **(kwargs or {})))
