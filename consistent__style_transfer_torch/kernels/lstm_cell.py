"""The LSTM cell's pointwise work: the gate sum, the four activations and the
cell update, ``(a, b, c) -> (h, c_new)`` with a = x W_ihᵀ + b_ih and
b = h W_hhᵀ + b_hh (B, 4H) in the gate order i, f, g, o, and c (B, H).

:func:`lstm_cell` runs it as one hand-written CUDA kernel forward
(``csrc/lstm_cell.cu``) and one backward, inside one
``torch.autograd.Function``, on CUDA tensors of three dtype pairs (gates /
cell state): bfloat16 / float32 (the encoder under autocast), bfloat16 /
bfloat16 (the decoder under autocast, bf16 serving) and float32 / float32.
The forward rounds every intermediate where eager PyTorch does, so it is
bit-identical to :func:`lstm_cell_reference`; the backward works in float32
and rounds once, so it rounds less often than autograd through the
reference. The forward keeps the gate sum (in the gates' dtype), c and
c_new for the backward, which recomputes the activations from the gate sum.
CPU tensors run :func:`lstm_cell_reference`; CUDA tensors of any other
dtype pair, shape or device mix raise (a tensor with a column stride other
than 1 is copied first).

Launch counts: ``kernel.lstm_cell_fwd`` and ``kernel.lstm_cell_bwd``
(``utils/profiling.py::count_step``; a graph replays its captured ones).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count_step
from ._build import load_library

# (gates dtype, cell-state dtype) -> csrc/lstm_cell.cu's Pair
PAIRS = {(torch.bfloat16, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
         (torch.float32, torch.float32): 2}


def lstm_cell_reference(a, b, c):
    """Plain version: the cell's equations in eager PyTorch, each op in the
    dtype its type promotion gives it. Returns (h, c_new)."""
    gates = a + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_cell_backward_reference(gates, c, c_new, dh, dc_new):
    """Plain version of the backward kernel: (dgates, dc) from the gate sum
    (B, 4H), c and c_new (B, H) and the gradients dh, dc_new (either None:
    zero), computed in float32 (float64 for float64 inputs) from activations
    recomputed from the gate sum, rounded once to the gates' and c's dtypes."""
    ct = torch.promote_types(gates.dtype, torch.float32)
    i, f, g, o = (t.to(ct) for t in gates.chunk(4, dim=-1))
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tc = torch.tanh(c_new.to(ct))
    zero = torch.zeros((), dtype=ct, device=gates.device)
    gh = zero if dh is None else dh.to(ct)
    dct = (zero if dc_new is None else dc_new.to(ct)) + gh * o * (1 - tc * tc)
    dgates = torch.cat([dct * g * i * (1 - i), dct * c.to(ct) * f * (1 - f),
                        dct * i * (1 - g * g), gh * tc * o * (1 - o)], dim=-1)
    return dgates.to(gates.dtype), (dct * f).to(c.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("lstm_cell")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.lstm_cell_forward.argtypes = [i32, ptr, i64, ptr, i64, ptr, i64, ptr, ptr, ptr, i32, i32,
                                      ptr]
    lib.lstm_cell_forward.restype = i32
    lib.lstm_cell_backward.argtypes = [i32, ptr, ptr, i64, ptr, ptr, i64, ptr, i64, ptr, ptr,
                                       i32, i32, ptr]
    lib.lstm_cell_backward.restype = i32
    lib.lstm_cell_error_string.argtypes = [i32]
    lib.lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def _pair(a, b, c) -> int:
    """csrc/lstm_cell.cu's Pair for CUDA inputs: a, b (B, 4H) and c (B, H),
    B and H at least 1, on one device, in one of :data:`PAIRS`. Raises
    TypeError for another dtype pair, ValueError for another shape or a
    mix of devices."""
    if b.device != a.device or c.device != a.device:
        raise ValueError(f"LSTM cell inputs on {a.device}, {b.device} and {c.device}: "
                         "want one device")
    pair = PAIRS.get((a.dtype, c.dtype))
    if pair is None or b.dtype != a.dtype:
        raise TypeError(f"the LSTM cell kernel takes (gates, cell state) in "
                        f"{[(str(g), str(s)) for g, s in PAIRS]}; got gates {a.dtype} and "
                        f"{b.dtype}, cell state {c.dtype}")
    if a.dim() != 2 or c.dim() != 2 or c.shape[0] < 1 or c.shape[1] < 1 \
            or tuple(a.shape) != (c.shape[0], 4 * c.shape[1]) or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"the LSTM cell kernel takes a, b (B, 4H) and c (B, H) with B, H >= 1; "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    return pair


def _check(err: int) -> None:
    if err != 0:
        msg = _library().lstm_cell_error_string(err).decode()
        raise RuntimeError(f"LSTM cell kernel launch failed: CUDA error {err} ({msg})")


def _unit_cols(t):
    """``t`` itself where its column stride is 1, else a contiguous copy."""
    return t if t is None or t.stride(-1) == 1 else t.contiguous()


def lstm_cell_fwd(a, b, c, keep_gates: bool):
    """Launch the forward kernel: (h, c_new, the gate sum or None). Inputs
    as :func:`_pair` takes them, each with a column stride of 1; h and c_new
    in c's dtype, contiguous."""
    pair = PAIRS[(a.dtype, c.dtype)]
    B, H = c.shape
    h = torch.empty(B, H, dtype=c.dtype, device=c.device)
    c_new = torch.empty_like(h)
    gates = torch.empty(B, 4 * H, dtype=a.dtype, device=a.device) if keep_gates else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _check(_library().lstm_cell_forward(
            pair, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), c.data_ptr(),
            c.stride(0), h.data_ptr(), c_new.data_ptr(),
            None if gates is None else gates.data_ptr(), B, H, stream))
    count_step("kernel.lstm_cell_fwd", 1)
    return h, c_new, gates


def lstm_cell_bwd(gates, c, c_new, dh, dc_new, want_dgates: bool, want_dc: bool):
    """Launch the backward kernel: (dgates or None, dc or None) from what the
    forward kept and the gradients of h and c_new (either None: zero)."""
    pair = PAIRS[(gates.dtype, c.dtype)]
    B, H = c.shape
    dh, dc_new = _unit_cols(dh), _unit_cols(dc_new)
    dgates = torch.empty_like(gates) if want_dgates else None
    dc = torch.empty(B, H, dtype=c.dtype, device=c.device) if want_dc else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ld(t):
        return 0 if t is None else t.stride(0)

    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        _check(_library().lstm_cell_backward(
            pair, gates.data_ptr(), c.data_ptr(), c.stride(0), c_new.data_ptr(), ptr(dh), ld(dh),
            ptr(dc_new), ld(dc_new), ptr(dgates), ptr(dc), B, H, stream))
    count_step("kernel.lstm_cell_bwd", 1)
    return dgates, dc


class FusedCell(torch.autograd.Function):
    """The cell as one forward and one backward: the kernels on CUDA
    tensors; on the CPU the plain forms (:func:`lstm_cell_reference`, the
    gate sum, :func:`lstm_cell_backward_reference`), for tests. The same
    dgates is the gradient of a and of b."""

    @staticmethod
    def forward(ctx, a, b, c):
        if a.device.type == "cuda":
            h, c_new, gates = lstm_cell_fwd(a, b, c, keep_gates=True)
        else:
            (h, c_new), gates = lstm_cell_reference(a, b, c), a + b
        ctx.save_for_backward(gates, c, c_new)
        ctx.set_materialize_grads(False)
        return h, c_new

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dc_new):
        if dh is None and dc_new is None:
            return None, None, None
        gates, c, c_new = ctx.saved_tensors
        need_a, need_b, need_c = ctx.needs_input_grad
        if gates.device.type == "cuda":
            dgates, dc = lstm_cell_bwd(gates, c, c_new, dh, dc_new, need_a or need_b, need_c)
        else:
            dgates, dc = lstm_cell_backward_reference(gates, c, c_new, dh, dc_new)
        return (dgates if need_a else None), (dgates if need_b else None), \
            (dc if need_c else None)


def lstm_cell(a, b, c):
    """(h, c_new) of one cell. On CUDA tensors the kernels (inputs checked
    by :func:`_pair`; a tensor with a column stride other than 1 copied
    first), through :class:`FusedCell` when a gradient is to flow, else the
    forward kernel alone. On the CPU :func:`lstm_cell_reference`."""
    if a.device.type != "cuda":
        return lstm_cell_reference(a, b, c)
    _pair(a, b, c)
    a, b, c = _unit_cols(a), _unit_cols(b), _unit_cols(c)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or c.requires_grad):
        return FusedCell.apply(a, b, c)
    h, c_new, _ = lstm_cell_fwd(a, b, c, keep_gates=False)
    return h, c_new
