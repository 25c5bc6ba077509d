"""Greedy decode head: FFN -> vocab projection -> argmax.

Each greedy decode step computes ``argmax_v(LeakyReLU_0.1(x W1^T + b1) W2^T)``
with x = [o_t; a_t] (B, 1024), W1 = ``fn_1.weight`` (512, 1024) and W2 =
``fn_2.weight`` (V, 512). Only the (B,) winners are needed, so the kernel
(``csrc/decode_step.cu``, replacing the JAX package's Pallas
``kernels/decode_step.py::fused_decode_logits``) never writes the (B, V)
logits. On a CUDA tensor :func:`fused_decode_logits` launches that kernel or
raises; on a CPU tensor it runs :func:`decode_head_reference`, the plain
version. ``kernel.fused_decode_logits`` counts kernel launches
(``utils/profiling.py::count_step``; a graph replays its captured ones):
one per call, which is two device kernels (the FFN, then the vocab product
with the argmax in its epilogue) and nothing else on the stream. The
launch captures as it is: the vocab kernel, a programmatic dependent of
the FFN kernel, becomes a programmatic edge of the graph, and the
per-device shared-memory attribute is set by an eager call before any
capture. bfloat16 runs on the tensor cores (wgmma on
TMA-fed tiles), float32 on the CUDA cores without TF32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.profiling import count_step
from ._build import load_library

_ENTRY = {torch.float32: "decode_head_f32", torch.bfloat16: "decode_head_bf16"}


def decode_head_reference(x, w1, b1, w2):
    """Plain version (the JAX package's ``decode_head_reference``) in the
    port's ``nn.Linear`` layout: x (B, Din), w1 (H, Din), b1 (H,), w2 (V, H).
    Computes in x's dtype; returns (ids int32 (B,), h (B, H))."""
    h = F.leaky_relu(F.linear(x, w1, b1), 0.1)
    return F.linear(h, w2).argmax(-1).to(torch.int32), h


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("decode_step")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.decode_step_error_string.argtypes = [i32]
    lib.decode_step_error_string.restype = ctypes.c_char_p
    return lib


def _workspace_bytes(B: int, H: int, dtype) -> int:
    """Bytes of the kernel's workspace (``Workspace`` in csrc/decode_step.cu):
    B argmax keys of 8 bytes, then for bf16 h rounded to bf16 (B, H) from the
    next 256-byte boundary."""
    keys = 8 * B
    return -(-keys // 256) * 256 + 2 * B * H if dtype == torch.bfloat16 else keys


def _check(x, w1, b1, w2) -> None:
    for name, t, ndim in (("x", x, 2), ("w1", w1, 2), ("b1", b1, 1), ("w2", w2, 2)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (TMA and 16-byte loads)")
    if x.dtype not in _ENTRY:
        raise TypeError(f"decode head kernel takes float32 or bfloat16, got {x.dtype}")
    (B, Din), (H, Din_w), (V, H_w) = x.shape, w1.shape, w2.shape
    if Din_w != Din or H_w != H or b1.shape[0] != H:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}")
    if B < 1 or V < 1 or Din % 16 or H % 16:
        raise ValueError(f"kernel needs B, V >= 1 and Din, H multiples of 16; "
                         f"got B={B} Din={Din} H={H} V={V}")


def fused_decode_logits(x, w1, b1, w2):
    """Returns (argmax ids int32 (B,), hidden h (B, H)) of the decode head.

    x (B, Din); w1 (H, Din); b1 (H,); w2 (V, H): all float32 or all bfloat16,
    contiguous, on one device. On CUDA, products accumulate in f32, h comes
    back in f32, and h is rounded to w2's dtype before the vocab product; ties
    go to the first index. On the CPU this is the plain version."""
    if x.device.type == "cpu":
        return decode_head_reference(x, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"decode head runs on cuda or cpu tensors, got {x.device}")
    _check(x, w1, b1, w2)
    B, Din = x.shape
    H, V = w1.shape[0], w2.shape[0]
    h = torch.empty(B, H, dtype=torch.float32, device=x.device)
    workspace = torch.empty(_workspace_bytes(B, H, x.dtype), dtype=torch.uint8, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), h.data_ptr(),
            workspace.data_ptr(), B, Din, H, V, stream)
    if err != 0:
        msg = lib.decode_step_error_string(err).decode()
        raise RuntimeError(f"decode head kernel launch failed: CUDA error {err} ({msg})")
    count_step("kernel.fused_decode_logits", 1)
    # each row's argmax key holds its column in its low word (little-endian):
    # the ids are an int32 view of the workspace, one per key
    ids = workspace[: 8 * B].view(torch.int32)[::2]
    return ids, h

