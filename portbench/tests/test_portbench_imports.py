"""What the benchmark loads: its run path imports neither JAX nor the JAX
package, the plain reference imports nothing of the port either, and
``run.py`` without a card exits non-zero with no result. Top-level module
names are compared whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "consistent__style_transfer_tpu"}
PORT = "consistent__style_transfer_torch"


def loaded_after(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    probe = (f"import sys; sys.path.insert(0, {ROOT!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_are_compared_whole():
    from portbench.lib.harness import forbidden_modules

    assert not forbidden_modules()  # this process loaded none of them either
    sys.modules.setdefault("consistent__style_transfer_torch_like", sys)
    try:
        assert "consistent__style_transfer_torch_like" not in forbidden_modules()
    finally:
        del sys.modules["consistent__style_transfer_torch_like"]


def test_the_run_path_imports_no_jax():
    code = ("import portbench.run as r; from portbench.lib.manifest import Manifest; "
            "m = Manifest(r.ROOT); [m.driver(c) for c in m.cells.values()]; "
            "[m.reader(n) for n in m.per_layer]; "
            "import consistent__style_transfer_torch.train.optimize, "
            "consistent__style_transfer_torch.train.pretrain")
    names = loaded_after(code)
    assert PORT in names
    assert not names & JAX_SIDE


def test_the_reference_imports_nothing_of_either_package():
    names = loaded_after("import portbench.reference.models, portbench.reference.optimize, "
                         "portbench.reference.pretrain, portbench.reference.wmd, "
                         "portbench.reference.compare, "
                         "portbench.reference.lowp")
    assert not names & (JAX_SIDE | {PORT})
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py")):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".", 1)[0] not in JAX_SIDE | {PORT}, (path, mod)


def test_nothing_reads_the_jax_benchmark():
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert "bench.py" not in text and "benchmarks/" not in text, path


def test_run_exits_nonzero_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", "book.pretrain", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_exits_nonzero_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "book.pretrain",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
