"""The port stands alone: it imports every module, decodes (greedy, the
beam of both backbones, the transformer generator), and runs a tiny
pretrain, warmup and optimize, its native text runtime, profiling and
full-state checkpoints, and its mesh and optimize-on-mesh exercise, with jax, flax, optax, orbax, the JAX package,
scikit-learn, gensim, fasttext and pyemd blocked (tests/test_torch_eval_cli.py
runs the eval commands so), names none of them in its sources or in
chip_smoke.py, builds its native library from ``native/tpust.cc`` into its
own build directory (never loading the JAX package's ``native/libtpust.so``),
and its entry points refuse to carry on without CUDA unless asked for the
CPU."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "consistent__style_transfer_torch")
BLOCKED = ("jax", "flax", "optax", "orbax", "consistent__style_transfer_tpu", "sklearn", "gensim",
           "fasttext", "pyemd")

_BLOCKED_RUN = r"""
import importlib, importlib.abc, importlib.machinery, pkgutil, sys

BLOCKED = %r
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Blocker(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    # a blocked module has a spec (with no origin: torch._dynamo probes
    # optional libraries, sklearn among them, with find_spec), and
    # importing it raises ImportError
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ImportError("blocked: " + spec.name)

    def exec_module(self, module):
        raise ImportError("blocked: " + module.__name__)

sys.meta_path.insert(0, Blocker())
sys.argv = ["consistent__style_transfer_torch", "--help"]  # for __main__

import torch
import consistent__style_transfer_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)

from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq, greedy_transfer
model = DenoiseSeq2Seq(n_vocab=40, n_class=2, max_len=5, seed=0).eval()
g = torch.Generator().manual_seed(0)
ids = greedy_transfer(model, torch.randint(0, 40, (3, 6), generator=g), torch.tensor([0, 1, 0]))
assert ids.shape == (3, 5) and ids.dtype == torch.int32, ids
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("DECODED", ids.tolist())
"""


_BLOCKED_PRETRAIN = r"""
import os
from consistent__style_transfer_torch.config import make_config
from consistent__style_transfer_torch.train.pretrain import run_pretrain

root = %r
os.makedirs(os.path.join(root, "data", "tiny"))
for split in ("train", "dev"):
    for label, words in ((0, "bad awful cold slow rude"), (1, "good great warm quick kind")):
        with open(os.path.join(root, "data", "tiny", f"style.{split}.{label}"), "w") as f:
            for i in range(8):
                w = words.split()
                print(f"the food was {w[i %% 5]} and {w[(i + 2) %% 5]} .", file=f)
cfg = make_config("tiny", data_dir=os.path.join(root, "data"), dump_dir=os.path.join(root, "dump"),
                  log_dir=os.path.join(root, "log"), device="cpu", dtype="float32", max_len=8,
                  batch_size=4, vocab_size=60, epochs=1, scorer_layers=1, scorer_d_model=16,
                  scorer_heads=2)
paths = run_pretrain(cfg, progress=False)
assert all(os.path.exists(p) for p in paths.values()), paths
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("PRETRAINED", sorted(paths))
"""


_BLOCKED_TRAINING = r"""
from consistent__style_transfer_torch import cli
from consistent__style_transfer_torch.ops.sampling import hard_sample_st
from consistent__style_transfer_torch.models.discriminator import RelGANDiscriminator
from consistent__style_transfer_torch.data.style_weights import style_neutrality_weights
from consistent__style_transfer_torch.train.warmup import run_warmup

flags = ["--dataset", "tiny", "--data_dir", os.path.join(root, "data"),
         "--dump_dir", os.path.join(root, "dump"), "--log_dir", os.path.join(root, "log"),
         "--out_dir", os.path.join(root, "out"), "--device", "cpu", "--max_len", "8",
         "--batch_size", "4", "--vocab_size", "60", "--scorer_layers", "1",
         "--scorer_d_model", "16", "--scorer_heads", "2", "--dtype", "float32"]
cli.main(["warmup", *flags, "--warmup_batch_size", "4"])
cli.main(["optimize", *flags, "--epochs", "1", "--w_copy", "0.5"])
dump = os.path.join(root, "dump", "tiny")
assert os.path.exists(os.path.join(dump, "warmup", "G.pth"))
assert os.listdir(os.path.join(dump, "optimize-v0")) == ["G_epoch_0.pth"]
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("TRAINED")
"""


_BLOCKED_NEW_MODULES = r"""
import tempfile
for name in ("text.native", "evaluate.l1r_native", "utils.profiling", "train.checkpoint",
             "train.graphs"):
    assert "consistent__style_transfer_torch." + name in sys.modules, name
from consistent__style_transfer_torch.train.graphs import GraphedStep, step_runner

eager = step_runner(lambda inputs, key: inputs["a"] + 1, torch.device("cpu"))
assert not isinstance(eager, GraphedStep) and int(eager({"a": torch.ones(())})) == 2
from consistent__style_transfer_torch.text.native import native_w2v_train
from consistent__style_transfer_torch.train.checkpoint import StateCheckpointer
from consistent__style_transfer_torch.utils.profiling import StepTimer, trace

vecs = native_w2v_train([[0, 1, 2, 1]] * 20, 3, dim=4, epochs=1, n_threads=1)
assert vecs.shape == (3, 4), vecs.shape
import numpy as np
from scipy import sparse
from consistent__style_transfer_torch.evaluate.lexicon import L1LogisticRegression
X = sparse.csr_matrix(np.eye(4)[[0, 1, 2, 3] * 5])
lr = L1LogisticRegression(C=3).fit(X, np.array([0, 0, 1, 1] * 5))
assert lr.n_iter_ >= 1 and lr.coef_[0, 2] > 0 > lr.coef_[0, 0], lr.coef_
with tempfile.TemporaryDirectory() as d:
    ckpt = StateCheckpointer(d)
    ckpt.save(0, {"w": torch.ones(2), "best": 1.0})
    assert ckpt.restore()["best"] == 1.0
    timer = StepTimer()
    with trace(d, enabled=True), timer:
        torch.ones(3).sum()
    assert [f for f in os.listdir(d) if f.startswith("trace-")], os.listdir(d)
    assert timer.summary()["steps"] == 1
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("NEW MODULES OK")
"""


_BLOCKED_BACKBONE = r"""
from consistent__style_transfer_torch.models.beam import beam_decode_any
from consistent__style_transfer_torch.models.seq2seq_transformer import TransformerSeq2Seq, generate
from consistent__style_transfer_torch.train.common import generator_call
from consistent__style_transfer_torch.train.infer import make_transfer_step
from consistent__style_transfer_torch.train.warmup import warmup_ckpt_name
from consistent__style_transfer_torch.utils.interop import transformer_generator_state_dict_from_jax

tf = TransformerSeq2Seq(n_vocab=40, n_class=2, max_len=5, d_model=16, n_heads=2, n_enc=1,
                        n_dec=1, d_ff=32).eval()
x, li = torch.randint(3, 40, (3, 6), generator=g), torch.tensor([0, 1, 0])
assert generate(tf, x, li, 1 - li, mode="st").shape == (3, 5, 40)
assert generator_call(tf, x, li, x, 1 - li).shape == (3, 6, 40)
for m in (tf, model):
    ids, scores = beam_decode_any(m, x, li, 1 - li, beam_size=3)
    assert ids.shape == (3, 5) and torch.isfinite(scores).all()
    assert torch.equal(make_transfer_step(m, 3)(x, li), ids)
assert callable(transformer_generator_state_dict_from_jax)
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("BACKBONE OK")
"""


_BLOCKED_LFM2 = r"""
for name in ("models.lfm2_moe", "models.moe"):
    assert "consistent__style_transfer_torch." + name in sys.modules, name
from consistent__style_transfer_torch.models.beam import beam_decode_any
from consistent__style_transfer_torch.models.lfm2_moe import Lfm2MoeGenerator, generate
from consistent__style_transfer_torch.train.common import generator_call

torch.set_num_threads(1)
g = torch.Generator().manual_seed(0)
m = Lfm2MoeGenerator(40, 2, 5, n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                     d_ff=48, d_expert=16, n_experts=8, top_k=4, n_dense=1)
x, li = torch.randint(3, 40, (3, 6), generator=g), torch.tensor([0, 1, 0])
probs = generate(m, x, li, 1 - li, mode="st")
logits = generator_call(m, x, li, x, 1 - li)
(probs.sum() + logits.square().mean()).backward()
assert all(p.grad is not None for n, p in m.named_parameters() if "router" not in n)
ids, scores = beam_decode_any(m.eval(), x, li, 1 - li, beam_size=2)
assert ids.shape == (3, 5) and torch.isfinite(scores).all()
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("LFM2 OK")
"""


_BLOCKED_PARALLEL = r"""
for name in ("parallel", "parallel.mesh", "parallel.sharding", "parallel.exercise"):
    assert "consistent__style_transfer_torch." + name in sys.modules, name
from consistent__style_transfer_torch.parallel import make_mesh, param_shardings, shard_batch
from consistent__style_transfer_torch.parallel.exercise import optimize_step_on_mesh
from consistent__style_transfer_torch.parallel.mesh import mesh_shape

torch.set_num_threads(1)
assert make_mesh(1, 1) is None and mesh_shape(None, 2, 4) == (2, 2)
try:
    make_mesh(2, 1)
    raise AssertionError("a 2 x 1 mesh in one process must raise")
except ValueError:
    pass
out = optimize_step_on_mesh(1, 1, vocab=32, max_len=6, n_steps=1, dtype="float32", p_drop=0.0,
                            device="cpu")
assert out["n_steps"] == 1 and all(map(abs, (out["g_loss"], out["d_loss"], out["val"]))), out
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print("PARALLEL OK")
"""


def _run_blocked(body: str) -> str:
    proc = subprocess.run([sys.executable, "-c", (_BLOCKED_RUN % (BLOCKED,)) + body], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_and_decodes_with_jax_blocked():
    assert "DECODED" in _run_blocked("")


def test_port_runs_a_tiny_pretrain_with_jax_blocked(tmp_path):
    assert "PRETRAINED ['cls', 'dn', 'mat']" in _run_blocked(_BLOCKED_PRETRAIN % str(tmp_path))


def test_port_runs_tiny_warmup_and_optimize_with_jax_blocked(tmp_path):
    """Through the CLI, after the tiny pretrain, on the CPU."""
    # one intra-op thread: the test workers share the cores
    out = _run_blocked("torch.set_num_threads(1)\n" + _BLOCKED_PRETRAIN % str(tmp_path)
                       + _BLOCKED_TRAINING)
    assert "TRAINED" in out and "best G:" in out


def test_beam_and_transformer_backbone_run_with_jax_blocked():
    """The transformer generator decodes, both backbones beam-decode and the
    transfer step takes the beam."""
    assert "BACKBONE OK" in _run_blocked(_BLOCKED_BACKBONE)


def test_lfm2_moe_backbone_runs_with_jax_blocked():
    """The LFM2-8B-A1B generator and its expert layer decode, take a
    backward and beam-decode."""
    assert "LFM2 OK" in _run_blocked(_BLOCKED_LFM2)


def test_native_profiling_checkpoint_run_with_jax_blocked():
    assert "NEW MODULES OK" in _run_blocked("import os\n" + _BLOCKED_NEW_MODULES)


def test_parallel_modules_run_with_jax_blocked():
    """The mesh, the sharding rules and the optimize exercise at (1, 1)."""
    assert "PARALLEL OK" in _run_blocked(_BLOCKED_PARALLEL)


def test_native_wrapper_loads_only_from_its_build_dir(monkeypatch, tmp_path):
    """Statically: the wrapper names no prebuilt library (the JAX package's
    ``native/libtpust.so``) and runs no ``make``; its one ``ctypes.CDLL``
    loads what ``build()`` returns. Then a build into an empty build dir
    leaves ``native/`` as it was, and the library lands in the build dir."""
    from consistent__style_transfer_torch.text import native

    path = os.path.join(PORT, "text", "native.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
               and isinstance(n.value, str)]
    assert not [v for v in strings if "libtpust" in v]
    assert "make" not in strings
    loads = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "ctypes.CDLL"]
    assert len(loads) == 1 and ast.unparse(loads[0].args[0]) == "build()"
    assert native.BUILD_DIR == os.path.join(ROOT, "build", "torch_native")
    assert native.SOURCE == os.path.join(ROOT, "native", "tpust.cc")

    def listing():
        return sorted((f, os.stat(os.path.join(ROOT, "native", f)).st_mtime_ns)
                      for f in os.listdir(os.path.join(ROOT, "native")))

    before = listing()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    built = native.build()
    assert os.path.dirname(built) == str(tmp_path) and os.path.exists(built)
    assert listing() == before


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_import_in_sources():
    """Static check of every port module and chip_smoke.py."""
    sources = list(_sources())
    assert len(sources) > 10 and os.path.exists(sources[-1])
    for path in sources:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path}:{node.lineno} imports {name}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No device given and no CUDA: raise, never carry on on the CPU."""
    from consistent__style_transfer_torch import cli
    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.train.common import get_device
    from consistent__style_transfer_torch.train.optimize import run_test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config("yelp", dump_dir=str(tmp_path), out_dir=str(tmp_path))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_device(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_test(cfg)
    for command in ("serve", "infer", "pretrain", "warmup", "optimize", "eval-prepare", "eval",
                    "run", "ablate"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([command, "--dump_dir", str(tmp_path), "--out_dir", str(tmp_path)])
    assert get_device(make_config("yelp", device="cpu")) == torch.device("cpu")


def test_backbone_and_beam_flags_raise_without_cuda(monkeypatch, tmp_path):
    """``--backbone transformer --beam_size 4`` changes nothing there: no
    CUDA and no ``--device cpu``, every generator command raises."""
    from consistent__style_transfer_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("serve", "infer", "warmup", "optimize", "run", "ablate"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([command, "--backbone", "transformer", "--beam_size", "4",
                      "--dump_dir", str(tmp_path), "--out_dir", str(tmp_path)])


def test_unported_commands_exit_2(capsys):
    from consistent__style_transfer_torch import cli

    assert cli.NOT_PORTED == ("bench",)
    for command in cli.NOT_PORTED:
        with pytest.raises(SystemExit) as e:
            cli.main([command])
        assert e.value.code == 2
        assert "ROADMAP.md" in capsys.readouterr().err
