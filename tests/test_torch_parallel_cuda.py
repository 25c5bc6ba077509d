"""The optimize stage's graphed step (``train/optimize.py::GraphedFusedStep``)
with the all-reduces of a data-parallel run captured in its graphs, on the
card: one process in a world-size-1 NCCL group (a free localhost port).
Every test needs a CUDA device and skips without one. This file imports no
JAX, so it runs on a machine that has only PyTorch (tests/conftest.py
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py

From the same seeded state, 9 graphed steps (D applying at steps 0, 4 and
8, so both branches are captured and replayed) with the group's optimizers
equal 9 without a group bit for bit in float32: losses, parameters, both
Adam states, D's accumulator and the generators' states. Once with dropout
off and the coins given, once with dropout on and the coins drawn from the
same generator states. A one-rank NCCL all-reduce leaves each value as it
is, so any difference would be the capture's: a collective that did not
replay, or replayed out of order. The graphs with the group hold more nodes
(the flat bucket's copies and the NCCL kernels). Two ranks on one card are
refused by NCCL; the multi-rank arithmetic is held on the CPU with gloo
(tests/test_torch_parallel_dp.py). The exercise
(``parallel/exercise.py::optimize_step_on_mesh``) runs on the card when no
device is given.
"""

import ctypes
import socket
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.parallel.mesh import (  # noqa: E402
    destroy_distributed,
    make_mesh,
)
from consistent__style_transfer_torch.parallel.sharding import data_group  # noqa: E402
from consistent__style_transfer_torch.train.optimize import (  # noqa: E402
    GraphedFusedStep,
    make_optimize_steps,
)
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402

pytestmark = pytest.mark.cuda
V, B, L, STEPS = 60, 8, 6, 9
SIZE = dict(d_model=32, n_heads=2, n_layers=2)


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and CUDA graphs exist only on the card")
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, 1)  # its device type from the group's backend
        assert mesh.device_type == "cuda"
        yield mesh
    finally:
        destroy_distributed()


def graph_nodes(graph) -> int:
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    assert err == 0, f"cuGraphGetNodes failed: CUresult {err}"
    return count.value


def _run(p_drop: float, group) -> dict:
    device = torch.device("cuda")
    cfg = make_config("tiny", device="cuda", dtype="float32", max_len=L, p_drop=p_drop,
                      w_copy=0.5)
    models = SimpleNamespace(
        generator=DenoiseSeq2Seq(V, 2, L, p_drop=p_drop, seed=1),
        classifier=TextCNN(V, p_drop=p_drop, seed=2),
        matcher=PairMatcher(V, p_drop=p_drop, seed=3, **SIZE),
        nt_checker=TransformerLM(V, p_drop=p_drop, seed=4, **SIZE),
        disc=RelGANDiscriminator(V, p_drop=p_drop, seed=5))
    for name in ("generator", "classifier", "matcher", "nt_checker", "disc"):
        setattr(models, name, getattr(models, name).to(device))
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    opts = (AdamWithClip(models.generator.parameters(), 1e-3, 1.0, group=group),
            AdamWithClip(models.disc.parameters(), 1e-3, 1.0, group=group))
    weights = np.random.default_rng(7).uniform(0.1, 1.0, V).astype(np.float32)
    steps = make_optimize_steps(cfg, models, *opts, copy_weights=weights, group=group)
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    gens = (torch.Generator(device).manual_seed(0), torch.Generator(device).manual_seed(1))
    given = p_drop == 0.0
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, torch.full((), 0.5, device=device),
                              given_coins=given)
    rng = np.random.default_rng(0)
    losses = []
    for i in range(STEPS):
        b = {"x": torch.from_numpy(rng.integers(3, V, (B, L)).astype(np.int32)).to(device),
             "labels": torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)}
        coins = torch.from_numpy(rng.integers(0, 2, L).astype(bool)).to(device)
        aux, d_loss = runner(b, i % 4 == 0, coins if given else None)
        losses.append(torch.stack([aux["loss"], aux["BK"], aux["COPY"], d_loss]).clone())
    torch.cuda.synchronize()
    assert sorted(runner.graphs) == [False, True]
    state = [p.detach().clone() for m in (models.generator, models.disc) for p in m.parameters()]
    state += [t.clone() for o in opts for st in o.adam.state.values() for t in st.values()]
    return {"losses": torch.stack(losses), "state": state + [a.clone() for a in acc],
            "gens": [g.get_state() for g in gens],
            "nodes": {k: graph_nodes(g) for k, g in runner.graphs.items()}}


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_graphed_steps_with_the_group_equal_steps_without(nccl_mesh, p_drop):
    group = data_group(nccl_mesh)
    assert group is not None
    plain, grouped = _run(p_drop, None), _run(p_drop, group)
    assert torch.isfinite(plain["losses"]).all()
    assert torch.equal(grouped["losses"], plain["losses"])
    assert len(grouped["state"]) == len(plain["state"])
    assert all(torch.equal(a, b) for a, b in zip(grouped["state"], plain["state"]))
    assert all(torch.equal(a, b) for a, b in zip(grouped["gens"], plain["gens"]))
    for branch in (False, True):
        assert grouped["nodes"][branch] > plain["nodes"][branch], (branch, grouped["nodes"],
                                                                   plain["nodes"])


def test_exercise_runs_on_the_card_by_default(nccl_mesh):
    """``optimize_step_on_mesh`` with no ``device`` runs on the card (here in
    the world-size-1 NCCL group) and returns finite numbers."""
    from consistent__style_transfer_torch.parallel.exercise import optimize_step_on_mesh

    torch.cuda.reset_peak_memory_stats()
    out = optimize_step_on_mesh(1, 1, n_steps=2, dtype="float32", p_drop=0.0)
    assert out["dist"] and out["n_steps"] == 2 and torch.cuda.max_memory_allocated() > 0
    assert all(np.isfinite(v) for v in (out["g_loss"], out["d_loss"], out["val"],
                                         *out["moments"].values()))
