"""The LSTM generator's one weight cast a call inside the optimize stage's
graphed step on the card (``DenoiseSeq2Seq.one_cast``,
``train/optimize.py::GraphedFusedStep``), at the yelp preset's widths (V =
10,000, B = 256, L = 18, the scorers and D at theirs). Every test needs a
CUDA device and skips without one. This file imports no JAX, so it runs on
a machine that has only PyTorch (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_generator_one_cast_cuda.py

- ``generator.weight_casts``: each replay of either branch adds 34 (the G
  step's scope and D's decode, 17 weights each), each replay of the graphed
  validation step 17;
- the captured graph of each branch has at least 1,000 nodes fewer than the
  same step's with ``one_cast`` replaced by a null context (autocast's
  recast at every product);
- replays equal eager steps bit for bit, dropout on, from the same saved
  state, on the line ``tests/test_torch_lfm2_moe_cuda.py`` holds: the
  losses, G's parameters and Adam state, the generators' states, and D's
  parameters while D is not applied (D's bf16 weight gradients may differ
  in their last bits between an eager step and a replay).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.models import DenoiseSeq2Seq  # noqa: E402
from consistent__style_transfer_torch.train.graphs import GraphedStep  # noqa: E402
from consistent__style_transfer_torch.train.optimize import (  # noqa: E402
    GraphedFusedStep,
    OptimizeModels,
    make_optimize_steps,
)
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda
V, USED = 10_000, 5_317  # the yelp models' rows; the committed corpus's BPE fills 5,317
COUNTER = "generator.weight_casts"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(device):
    cfg = make_config("yelp", device="cuda")
    models = OptimizeModels(cfg, V, device)
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    opts = (AdamWithClip(models.generator.parameters(), cfg.optimize_lr, cfg.optimize_clip),
            AdamWithClip(models.disc.parameters(), cfg.optimize_lr, cfg.optimize_clip))
    steps = make_optimize_steps(cfg, models, *opts)
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    gens = (torch.Generator(device).manual_seed(0), torch.Generator(device).manual_seed(1))
    return cfg, models, steps, opts, acc, gens


def _batches(cfg, device, n, seed=0):
    rng = np.random.default_rng(seed)
    B, L = cfg.batch_size, cfg.max_len
    return [{"x": torch.from_numpy(rng.integers(3, USED, (B, L)).astype(np.int32)).to(device),
             "labels": torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)}
            for _ in range(n)]


def _casts(counts) -> int:
    return sum(n for name, n in counts if name == COUNTER)


def _captured(device):
    """Both branches of the fused step captured (D held, then D applied):
    (runner, each branch's node count, the setup)."""
    cfg, models, steps, opts, acc, gens = _setup(device)
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, torch.ones((), device=device))
    for do_apply, b in zip((False, True), _batches(cfg, device, 2)):
        runner(b, do_apply)
    torch.cuda.synchronize()
    nodes = {k: profiling.graph_nodes(g) for k, g in runner.graphs.items()}
    return runner, nodes, (cfg, models, steps, opts, acc, gens)


def test_casts_are_counted_at_each_replay(cuda_device, monkeypatch):
    runner, _, (cfg, models, steps, *_) = _captured(cuda_device)
    assert {k: _casts(c) for k, c in runner.replay_counts.items()} == {False: 34, True: 34}
    val = GraphedStep(lambda inputs, _: [steps.val_step(inputs)], name="optimize.val_step")
    batch = _batches(cfg, cuda_device, 1, seed=1)[0]
    val(batch)  # the eager first call, then the capture
    assert _casts(val.replay_counts[None]) == 17
    monkeypatch.setattr(profiling.RECORDER, "env", True)
    profiling.RECORDER.clear()
    try:
        for do_apply in (False, True, False):
            runner(batch, do_apply)
        val(batch)
        torch.cuda.synchronize()
        got = sum(n for name, _, n in profiling.RECORDER.counters if name == COUNTER)
    finally:
        profiling.RECORDER.clear()
    assert got == 3 * 34 + 17


def test_the_scope_takes_at_least_1000_nodes_off_each_branch(cuda_device, monkeypatch):
    _, nodes, _ = _captured(cuda_device)
    with monkeypatch.context() as m:
        m.setattr(DenoiseSeq2Seq, "one_cast", lambda self: contextlib.nullcontext())
        runner, nulled, _ = _captured(cuda_device)
        assert not any(_casts(c) for c in runner.replay_counts.values())
    print({"nodes": nodes, "nulled": nulled})
    assert nodes.keys() == nulled.keys() == {False, True}
    assert all(nulled[k] - nodes[k] >= 1000 for k in nodes), (nodes, nulled)


@pytest.mark.parametrize("apply", [(False, False, False), (True,)], ids=["d_held", "d_apply"])
def test_replays_equal_eager_steps_bit_for_bit(cuda_device, apply):
    runner, _, (cfg, models, steps, opts, acc, gens) = _captured(cuda_device)
    scale = torch.ones((), device=cuda_device)
    batches = _batches(cfg, cuda_device, len(apply), seed=2)
    g_params = list(models.generator.parameters())
    d_params = list(models.disc.parameters())
    g_adam = [t for st in opts[0].adam.state.values() for t in st.values()
              if isinstance(t, torch.Tensor)]
    held = g_params + g_adam + ([] if any(apply) else d_params)
    state = g_params + d_params + acc + [t for o in opts for st in o.adam.state.values()
                                         for t in st.values() if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in state]
    saved_gens = [g.get_state() for g in gens]

    def run(graphed):
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        for g, s in zip(gens, saved_gens):
            g.set_state(s)
        losses = []
        for do_apply, b in zip(apply, batches):
            aux, d_loss = (runner(b, do_apply) if graphed
                           else steps.fused_step(b, acc, do_apply, *gens, scale))
            losses.append(torch.stack([aux["loss"], aux["BK"], d_loss]).clone())
        torch.cuda.synchronize()
        return (torch.stack(losses), [t.detach().clone() for t in held],
                [g.get_state() for g in gens])

    l0, s0, g0 = run(False)
    l1, s1, g1 = run(True)
    assert torch.isfinite(l0).all()
    assert any(not torch.equal(a, b) for a, b in zip(s0[:len(g_params)], saved))
    assert torch.equal(l1, l0), float((l1 - l0).abs().max())
    gaps = [float((a - b).abs().max()) for a, b in zip(s1, s0) if not torch.equal(a, b)]
    assert not gaps, f"{len(gaps)} of {len(s0)} tensors differ, by up to {max(gaps):.3g}"
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))
