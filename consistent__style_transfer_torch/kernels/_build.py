"""Build of the port's CUDA sources: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

A library builds at first use, from the sources in the package's ``csrc/``
alone, into ``build/torch_kernels/`` at the root of the checkout, under a
name keyed by a hash of the source and the flags; a later call with the same
source loads the library that is there. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside it as ``.log``.
Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels build on a machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to; the name changes with the source."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` for sm_90a unless it is built; return the
    library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))
