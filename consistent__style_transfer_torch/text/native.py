"""ctypes bindings of the repo's C++ text runtime (``native/tpust.cc``): the
port's own wrapper, with the C signatures the JAX package's
``text/native.py`` declares.

- :class:`NativeBPE`: the CharBPE tokenizer's encode, batch encode and
  decode in C++, from the vocab and merge tables of a
  :class:`~.bpe.BPETokenizer` (ids equal the Python tokenizer's);
- :func:`native_bpe_train`: merge training in C++ (the same vocab and merges
  as ``BPETokenizer.train``);
- :func:`native_w2v_train`: hogwild CBOW word2vec with negative sampling over
  an int corpus, returning the (V, D) embedding matrix.

The library builds at first use with ``g++`` and the flags of
``native/Makefile``, from ``native/tpust.cc`` as it stands in the checkout,
into ``build/torch_native/`` at the root of the checkout, under a name keyed
by a hash of the source, the flags and the target options ``-march=native``
expands to on this host (so a library built on one machine is never loaded
on another); a later call loads the library that is there. Nothing here runs
at import time. A failed build raises with the compiler's output: the port
never falls back to its Python paths on its own. Those stay reachable by an
explicit ``prefer_native=False`` where a caller offers it. ``build(source)``
builds another host C++ file of the port the same way (``csrc/l1r_lr.cc``,
bound in :mod:`..evaluate.l1r_native`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "tpust.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-pthread")
SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")
_TRAIN_BUFFER = 1 << 24  # bytes for each of the trained token and merge blobs


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the port's host C++ (native/tpust.cc, "
                           "csrc/l1r_lr.cc) builds with it")
    return found


def library_path(cxx: str, source: str = SOURCE) -> str:
    """Where ``source`` builds to for the compiler ``cxx``; the name changes
    with the source, the flags and what ``-march=native`` means here."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True)
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS + LD_FLAGS).encode() + b"\0" + target.stdout.encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str = SOURCE) -> str:
    """Compile the C++ file ``source`` (``native/tpust.cc`` unless given)
    into a shared library unless it is built; return the library's path.
    Raises with the compiler's output when the build fails."""
    cxx = compiler()
    out = library_path(cxx, source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, *LD_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every function's argument and result types
    declared (the JAX package's ``text/native.py:27-60``)."""
    lib = ctypes.CDLL(build())
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.tpust_bpe_new.restype = ctypes.c_void_p
    lib.tpust_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tpust_bpe_free.restype = None
    lib.tpust_bpe_free.argtypes = [ctypes.c_void_p]
    lib.tpust_bpe_vocab_size.restype = ctypes.c_int
    lib.tpust_bpe_vocab_size.argtypes = [ctypes.c_void_p]
    lib.tpust_bpe_encode.restype = ctypes.c_int
    lib.tpust_bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i32, ctypes.c_int]
    lib.tpust_bpe_encode_batch.restype = ctypes.c_int
    lib.tpust_bpe_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                           i32, i32, ctypes.c_int]
    lib.tpust_bpe_decode.restype = ctypes.c_int
    lib.tpust_bpe_decode.argtypes = [ctypes.c_void_p, i32, ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.tpust_bpe_train.restype = ctypes.c_int
    lib.tpust_bpe_train.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.tpust_w2v_train.restype = None
    lib.tpust_w2v_train.argtypes = [
        i32, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_int, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    return lib


class NativeBPE:
    """The CharBPE tokenizer in C++ over the vocab and merge tables of a
    Python :class:`~.bpe.BPETokenizer` (:meth:`from_python`): the same ids,
    the same decoded text."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self._lib = load()
        self.vocab = dict(vocab)
        self.merges = list(merges)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        tokens_blob = "\n".join(t for t, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]))
        merges_blob = "\n".join(f"{a} {b}" for a, b in self.merges)
        self._h = self._lib.tpust_bpe_new(tokens_blob.encode(), merges_blob.encode())
        if not self._h:
            raise RuntimeError("tpust_bpe_new returned no tokenizer")

    @classmethod
    def from_python(cls, tok) -> "NativeBPE":
        return cls(tok.vocab, tok.merges)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.tpust_bpe_free(h)

    def __len__(self) -> int:
        return int(self._lib.tpust_bpe_vocab_size(self._h))

    def encode(self, text: str) -> list[int]:
        raw = text.encode()
        out = np.empty(4 * max(len(raw), 1), dtype=np.int32)
        n = self._lib.tpust_bpe_encode(self._h, raw, out, len(out))
        return out[:n].tolist()

    def encode_batch(self, lines: list[str], max_len: int, pad_id: int = 0):
        """Encode into a fixed-shape (N, max_len) int32 array, padded with
        ``pad_id``, and the (N,) lengths, each line cut at ``max_len``."""
        blob = "\n".join(line if line.strip() else " " for line in lines)
        n = len(lines)
        ids = np.full((n, max_len), pad_id, dtype=np.int32)
        lens = np.zeros(n, dtype=np.int32)
        done = self._lib.tpust_bpe_encode_batch(self._h, blob.encode(), max_len, ids, lens, n)
        if done != n:
            raise RuntimeError(f"tpust_bpe_encode_batch encoded {done} of {n} lines")
        return ids, lens

    def decode(self, ids, skip_special: bool = True) -> str:
        """Text of ``ids`` with the special tokens left out (the C++ decode
        always skips them; ``skip_special`` is there for the Python
        tokenizer's signature)."""
        arr = np.ascontiguousarray(ids, dtype=np.int32)
        buf = ctypes.create_string_buffer(16 * max(len(arr), 1) + 16)
        n = self._lib.tpust_bpe_decode(self._h, arr, len(arr), buf, len(buf))
        return buf.raw[:n].decode("utf-8", errors="replace")

    def ids_to_tokens(self, ids) -> list[str]:
        return [self.inv_vocab.get(int(i), "<unk>") for i in ids]


def native_bpe_train(files, vocab_size: int, specials=SPECIALS):
    """Train the merges in C++ over the lines of ``files``; returns (vocab
    dict, merges list), equal to ``BPETokenizer.train``'s tables."""
    corpus = []
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            corpus.append(f.read())
    out_tokens = ctypes.create_string_buffer(_TRAIN_BUFFER)
    out_merges = ctypes.create_string_buffer(_TRAIN_BUFFER)
    n = load().tpust_bpe_train("\n".join(corpus).encode(), vocab_size,
                               "\n".join(specials).encode(), out_tokens, len(out_tokens),
                               out_merges, len(out_merges))
    if n <= 0:
        raise RuntimeError(f"tpust_bpe_train failed ({n}): a table exceeds {_TRAIN_BUFFER} bytes")
    vocab = {t: i for i, t in enumerate(out_tokens.value.decode().splitlines())}
    merges = [tuple(line.split(" ")) for line in out_merges.value.decode().splitlines()]
    return vocab, merges


def default_threads() -> int:
    return min(os.cpu_count() or 1, 8)


def native_w2v_train(sentences, vocab_size: int, dim: int = 100, window: int = 5,
                     negative: int = 5, epochs: int = 5, lr: float = 0.025,
                     min_lr: float = 1e-4, sample: float = 1e-3, seed: int = 1,
                     n_threads: int | None = None) -> np.ndarray:
    """CBOW word2vec with negative sampling over ``sentences`` (lists of ids
    below ``vocab_size``) in C++: (vocab_size, dim) float32 input vectors.
    ``n_threads`` hogwild workers (default ``min(cpu_count, 8)``); with one
    the result is a function of the seed alone."""
    kept = [np.asarray(s, np.int32) for s in sentences if len(s)]
    flat = np.concatenate(kept) if kept else np.zeros(0, np.int32)
    lens = np.asarray([len(s) for s in kept], np.int32)
    if flat.size and (flat.min() < 0 or flat.max() >= vocab_size):
        raise ValueError(f"ids must lie in [0, {vocab_size})")
    counts = np.bincount(flat, minlength=vocab_size).astype(np.int64)
    out = np.zeros((vocab_size, dim), np.float32)
    load().tpust_w2v_train(flat, lens, len(lens), vocab_size, dim, window, negative, epochs,
                           lr, min_lr, sample, seed, n_threads or default_threads(), counts, out)
    return out
