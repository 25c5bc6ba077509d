"""Batched Sinkhorn optimal-transport cost: the WMD label of every pretrain
batch while the matcher trains.

The JAX package has two Pallas kernels for it, ``sinkhorn_pallas`` (8 pairs
per program, atoms padded to 128 lanes) and ``sinkhorn_pallas_cr`` (one pair
per program, potentials as a column and a row); both compute exactly
``ops/emd.py::sinkhorn_ot_cost``. Their layouts are TPU needs, so here both
names are thin entries onto one hand-written CUDA kernel
(``csrc/sinkhorn.cu``: one warp per pair, valid atoms compacted, no block
barrier), with the JAX signature less the TPU-only ``group``, ``lanes`` and
``interpret`` arguments.

On a CUDA tensor each entry launches that kernel or raises; on a CPU tensor
it runs :func:`~..ops.emd.sinkhorn_ot_cost`, the plain version.
``sinkhorn_cuda.launches`` counts the kernel's launches through either name;
a call on a stream that a CUDA graph is capturing counts into
``.captured``, and the graph adds those to ``.launches`` at every replay
(``train/graphs.py::GraphedStep``). The pretrain path launches it in the
collate, outside any graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.emd import sinkhorn_ot_cost
from . import count_launch
from ._build import load_library

MAX_ATOMS = 64  # csrc/sinkhorn.cu kCap


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("sinkhorn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sinkhorn_f32.argtypes = [ptr] * 4 + [i32] * 3 + [ctypes.c_float, i32, ptr]
    lib.sinkhorn_f32.restype = i32
    lib.sinkhorn_max_atoms.argtypes = []
    lib.sinkhorn_max_atoms.restype = i32
    lib.sinkhorn_error_string.argtypes = [i32]
    lib.sinkhorn_error_string.restype = ctypes.c_char_p
    if lib.sinkhorn_max_atoms() != MAX_ATOMS:
        raise RuntimeError(f"csrc/sinkhorn.cu takes {lib.sinkhorn_max_atoms()} atoms, "
                           f"the wrapper expects {MAX_ATOMS}")
    return lib


def _check(p, q, D) -> None:
    for name, t, ndim in (("p", p, 2), ("q", q, 2), ("D", D, 3)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the Sinkhorn kernel takes float32, {name} is {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")
    (B, N), M = p.shape, q.shape[1]
    if q.shape[0] != B or tuple(D.shape) != (B, N, M):
        raise ValueError(f"shapes do not match: p {tuple(p.shape)}, q {tuple(q.shape)}, "
                         f"D {tuple(D.shape)}")
    if B < 1 or not (1 <= N <= MAX_ATOMS and 1 <= M <= MAX_ATOMS):
        raise ValueError(f"the Sinkhorn kernel takes B >= 1 and 1 <= N, M <= {MAX_ATOMS}; "
                         f"got B={B} N={N} M={M}")


def sinkhorn_cuda(p, q, D, epsilon: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """Launch ``csrc/sinkhorn.cu`` on the current stream: (B,) float32 costs
    of p (B, N), q (B, M), D (B, N, M), contiguous float32 on one CUDA device."""
    if p.device.type != "cuda":
        raise ValueError(f"the Sinkhorn kernel runs on cuda tensors, got {p.device}")
    _check(p, q, D)
    B, N = p.shape
    M = q.shape[1]
    out = torch.empty(B, dtype=torch.float32, device=p.device)
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sinkhorn_f32(p.data_ptr(), q.data_ptr(), D.data_ptr(), out.data_ptr(),
                               B, N, M, float(epsilon), int(n_iters), stream)
    if err != 0:
        msg = lib.sinkhorn_error_string(err).decode()
        raise RuntimeError(f"Sinkhorn kernel launch failed: CUDA error {err} ({msg})")
    count_launch(sinkhorn_cuda)
    return out


sinkhorn_cuda.launches = 0
sinkhorn_cuda.captured = 0


def _entry(p, q, D, epsilon: float, n_iters: int) -> torch.Tensor:
    if p.device.type == "cpu":
        return sinkhorn_ot_cost(p, q, D, epsilon=epsilon, n_iters=n_iters)
    return sinkhorn_cuda(p, q, D, epsilon=epsilon, n_iters=n_iters)


def sinkhorn_pallas(p, q, D, epsilon: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """Counterpart of the JAX ``kernels/sinkhorn.py::sinkhorn_pallas``:
    (B,) transport costs of p (B, N), q (B, M), D (B, N, M) float32."""
    return _entry(p, q, D, epsilon, n_iters)


def sinkhorn_pallas_cr(p, q, D, epsilon: float = 0.05, n_iters: int = 100) -> torch.Tensor:
    """Counterpart of the JAX ``kernels/sinkhorn.py::sinkhorn_pallas_cr``;
    the same function as :func:`sinkhorn_pallas`, on the same kernel."""
    return _entry(p, q, D, epsilon, n_iters)
