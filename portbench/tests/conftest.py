"""Shared set-up of the benchmark's own tests: the checkout on the import
path, a card fixture for the ``cuda`` tests, and a tiny checkout (the
benchmark's files and a cut corpus) for runs of a cell on the CPU."""

from __future__ import annotations

import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the sizes a CPU run can hold: the published widths of the generator, the
# classifier and D (the port fixes them), a small batch and small scorers
TINY = {"batch_size": 8, "dtype": "float32",
        "scorers": {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 2048, "max_pos": 100,
                    "p_drop": 0.1}}
TINY_VOCAB = {"yelp": 10000, "book": 300}  # yelp's cut corpus stops short of 10,000 anyway


def make_checkout(dst: str, lines: int = 200) -> str:
    """A checkout of the benchmark's files with the first ``lines`` lines of
    each corpus file."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for ds in ("yelp", "book"):
        os.makedirs(os.path.join(dst, "data", ds))
        for name in os.listdir(os.path.join(ROOT, "data", ds)):
            with open(os.path.join(ROOT, "data", ds, name), encoding="utf-8") as a, \
                    open(os.path.join(dst, "data", ds, name), "w", encoding="utf-8") as b:
                for i, line in enumerate(a):
                    if i >= lines:
                        break
                    b.write(line)
    return dst


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def run_cpu(root: str, workload: str, seed: int = 3_000_000_001, seconds: float = 2.0,
            trace: int = 0, control: int = 0) -> dict:
    """One run of ``workload`` on the CPU at the tiny sizes (the look for a
    card skipped)."""
    from portbench import run

    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace), "--control", str(control)])
    overrides = dict(TINY, vocab_size=TINY_VOCAB[workload.split(".")[0]])
    return run.execute(args, "cpu", root=root, overrides=overrides)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
