"""ctypes binding of the port's L1 logistic regression solver in C++
(``csrc/l1r_lr.cc``: liblinear's newGLMNET, ``solve_l1r_lr``, a line-for-line
port of :func:`~.lexicon._solve_l1r_lr`).

The library builds at first use with ``g++`` and the flags of the native text
runtime (:mod:`..text.native`: ``CXX_FLAGS``, ``LD_FLAGS``), into
``build/torch_native/`` under a name keyed by a hash of the source, the
flags and what ``-march=native`` expands to on this host, as that runtime's
library is; a later call loads the library that is there. Nothing here runs
at import time. A failed build raises with the compiler's output: the port
never falls back to the Python solver on its own
(``L1LogisticRegression(prefer_native=False)`` asks for it).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
from scipy import sparse

from ..text import native

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "l1r_lr.cc")


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with ``tpust_l1r_lr``'s argument and result types."""
    lib = ctypes.CDLL(native.build(SOURCE))

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    lib.tpust_l1r_lr.restype = ctypes.c_int
    lib.tpust_l1r_lr.argtypes = [
        ctypes.c_int64, ctypes.c_int64, arr(np.int64), arr(np.int32), arr(np.float64),
        arr(np.float64), ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_uint64,
        arr(np.float64), ctypes.POINTER(ctypes.c_int64)]
    return lib


def solve_l1r_lr(X: sparse.csc_matrix, s: np.ndarray, C: float, eps: float,
                 max_newton_iter: int, seed: int) -> tuple[np.ndarray, int, int]:
    """newGLMNET in C++ on a CSC float64 X (l, n) whose last column is the
    bias feature; s = +-1 (l,). Returns (w (n,), Newton iterations, inner
    passes summed over them); the coordinate order comes from ``seed``
    (splitmix64, see the source)."""
    X = sparse.csc_matrix(X)
    l, n = X.shape
    s = np.ascontiguousarray(s, np.float64)
    if s.shape != (l,):
        raise ValueError(f"s has shape {s.shape}; X has {l} rows")
    indptr = np.ascontiguousarray(X.indptr, np.int64)
    indices = np.ascontiguousarray(X.indices, np.int32)
    data = np.ascontiguousarray(X.data, np.float64)
    w = np.zeros(n, np.float64)
    inner = ctypes.c_int64(0)
    newton = load().tpust_l1r_lr(l, n, indptr, indices, data, s, C, eps, max_newton_iter,
                                 seed % (1 << 64), w, ctypes.byref(inner))
    if newton < 0:
        raise RuntimeError(f"tpust_l1r_lr refused a ({l}, {n}) problem")
    return w, int(newton), int(inner.value)
