"""Build of the port's CUDA sources: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

A library builds at first use, from the sources in the package's ``csrc/``
alone, into ``build/torch_kernels/`` at the root of the checkout, under a
name keyed by a hash of everything that builds it: the source, every
``csrc/`` header it includes (directly or through another header), the
common flags and the source's own (``SOURCE_FLAGS``); a later call with the
same inputs loads the library that is there. The compiler's report
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept beside
it as ``.log``.
Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of one source, after it on the command line. decode_step encodes TMA
# tensor maps with cuTensorMapEncodeTiled, which libcuda exports.
SOURCE_FLAGS = {"decode_step": ("-lcuda",)}
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels build on a machine with the CUDA toolkit")


def local_headers(src: str, csrc_dir: str = CSRC_DIR) -> list[str]:
    """The headers under ``csrc_dir`` that ``src`` includes with quotes,
    directly or through one another, sorted; a name that is no file there
    (a system header) is skipped."""
    root = os.path.join(os.path.abspath(csrc_dir), "")
    found: set[str] = set()
    todo = [src]
    while todo:
        current = todo.pop()
        with open(current, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            path = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(current)),
                                                 inc.decode()))
            if path.startswith(root) and path not in found and os.path.isfile(path):
                found.add(path)
                todo.append(path)
    return sorted(found)


def library_path(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """Where ``<csrc_dir>/<name>.cu`` builds to; the name changes with the
    source, any header it includes and the flags."""
    src = os.path.join(csrc_dir, f"{name}.cu")
    digest = hashlib.sha256()
    for path in (src, *local_headers(src, csrc_dir)):
        with open(path, "rb") as f:
            digest.update(os.path.relpath(path, csrc_dir).encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _link_dirs(nvcc: str) -> list[str]:
    """-L for the toolkit's stub of libcuda (the real one is loaded
    at run time under its soname)."""
    home = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    return [f"-L{d}" for d in (os.path.join(home, "lib64", "stubs"),
                               os.path.join(home, "targets", "x86_64-linux", "lib", "stubs"))
            if os.path.isdir(d)]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` for sm_90a unless it is built; return the
    library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    nvcc = nvcc_path()
    flags = SOURCE_FLAGS.get(name, ())
    link = _link_dirs(nvcc) if any(f.startswith("-l") for f in flags) else []
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src, *link, *flags],
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
