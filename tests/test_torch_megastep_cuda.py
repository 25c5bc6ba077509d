"""The optimize stage's graphed step (``train/optimize.py::GraphedFusedStep``,
every training step of ``run_optimize`` on the card) against the eager
``fused_step`` on the card, from the same state. Every test needs a CUDA
device and skips without one. This file imports no JAX, so it runs on a
machine that has only PyTorch (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_megastep_cuda.py

Two ways to make both runs draw the same random numbers:

- dropout off in every module and the sched coins given, so neither run
  draws anything: 11 steps with D applying every 4th (both branches
  replayed at least twice, the last two steps accumulating only), in
  float32 and under bfloat16 autocast;
- dropout on (p=0.1) and the coins drawn, in float32, at L=6 and at the
  book preset's L=30: both branches are
  captured first, then the parameters, both Adam states, the accumulator
  and the two generators' states are saved, and 9 eager steps and 9
  replays each start from that saved state. A replay that read a stale seed
  or offset, or drew from the other generator, would draw other masks and
  coins and fail here.

Tolerances (chip_smoke.py phase 8's): losses within 1e-5 relative in
float32 and 5e-2 under bfloat16 autocast; in float32 the mean absolute
difference of the parameters within 1e-3 of their mean absolute move, and
of the accumulator within 1e-3 of its mean absolute entry. The same kernels
run in the same order, but atomics in a backward may sum in another order,
and a gradient entry near 0 can then flip the sign of its Adam step, so the
largest difference is not bounded. float32 is the strict check (measured on
an H100: bit for bit): under bf16 a product summed in another order (cuBLAS
may pick another kernel on the capture stream) moves an output by a bf16
step, 0.4%, and can flip an argmax of the straight-through decode, which
these near-uniform tiny models do often (measured: losses 1.5% apart,
parameters 11% of their move), so bf16 holds the losses here and
chip_smoke.py phase 8 holds the parameters at full yelp width.
"""

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
from consistent__style_transfer_torch.train.optimize import (  # noqa: E402
    GraphedFusedStep,
    make_optimize_steps,
)
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402

pytestmark = pytest.mark.cuda
V, B, L, STEPS = 60, 8, 6, 11
BOOK_L = 30  # the book preset's max_len (config.py)
SIZE = dict(d_model=32, n_heads=2, n_layers=2)
TOL = {"float32": (1e-5, 1e-3), "bfloat16": (5e-2, None)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(device, dtype, p_drop, length=L):
    cfg = make_config("tiny", device="cuda", dtype=dtype, max_len=length, p_drop=p_drop,
                      w_copy=0.5)
    models = SimpleNamespace(
        generator=DenoiseSeq2Seq(V, 2, length, p_drop=p_drop, seed=1),
        classifier=TextCNN(V, p_drop=p_drop, seed=2),
        matcher=PairMatcher(V, p_drop=p_drop, seed=3, **SIZE),
        nt_checker=TransformerLM(V, p_drop=p_drop, seed=4, **SIZE),
        disc=RelGANDiscriminator(V, p_drop=p_drop, seed=5))
    for name in ("generator", "classifier", "matcher", "nt_checker", "disc"):
        setattr(models, name, getattr(models, name).to(device))
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    opts = (AdamWithClip(models.generator.parameters(), 1e-3, 1.0),
            AdamWithClip(models.disc.parameters(), 1e-3, 1.0))
    steps = make_optimize_steps(cfg, models, *opts)
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    gens = (torch.Generator(device).manual_seed(0), torch.Generator(device).manual_seed(1))
    return models, steps, opts, acc, gens


def _params(models):
    return [p for m in (models.generator, models.disc) for p in m.parameters()]


def _mean_abs(xs, ys):
    return float(torch.cat([(x - y).abs().flatten() for x, y in zip(xs, ys)]).mean())


def _batches(device, length=L):
    rng = np.random.default_rng(0)
    return [{"x": torch.from_numpy(rng.integers(3, V, (B, length)).astype(np.int32)).to(device),
             "labels": torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device),
             "coins": torch.from_numpy(rng.integers(0, 2, length).astype(bool)).to(device)}
            for _ in range(STEPS)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replays_equal_eager_fused_step(cuda_device, dtype):
    batches = _batches(cuda_device)
    runs = []
    for graphed in (False, True):
        models, steps, _, acc, gens = _setup(cuda_device, dtype, 0.0)
        start = [p.detach().clone() for p in _params(models)]
        scale = torch.full((), 0.5, device=cuda_device)
        runner = GraphedFusedStep(steps.fused_step, acc, *gens, scale, given_coins=True) \
            if graphed else None
        losses = []
        for i, b in enumerate(batches):
            do_apply = i % 4 == 0
            if graphed:
                aux, d_loss = runner(b, do_apply, b["coins"])
            else:
                aux, d_loss = steps.fused_step(b, acc, do_apply, *gens, scale, b["coins"])
            losses.append(torch.stack([aux["loss"], aux["COPY"], d_loss]).clone())
        torch.cuda.synchronize()
        if graphed:
            assert sorted(runner.graphs) == [False, True]
        params = [p.detach().clone() for p in _params(models)]
        runs.append((torch.stack(losses), params, [a.clone() for a in acc], start))
    rel, share = TOL[dtype]
    (l0, p0, a0, s0), (l1, p1, a1, _) = runs
    assert torch.isfinite(l0).all()
    assert float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max()) <= rel
    move = _mean_abs(p0, s0)
    assert move > 1e-5  # the run moved the parameters
    if dtype == "float32":
        # under bf16 these near-uniform tiny models decode other tokens
        # wherever an argmax flipped (measured: parameters 11% of their
        # move apart), so parameters and accumulator are held in float32;
        # chip_smoke.py phase 8 holds them under bf16 at full yelp width
        assert _mean_abs(p1, p0) <= share * move
        assert _mean_abs(a1, a0) <= share * float(torch.cat([a.abs().flatten() for a in a0]).mean())


def test_replays_draw_new_dropout_masks(cuda_device):
    models, steps, _, acc, gens = _setup(cuda_device, "float32", 0.3)
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, torch.ones((), device=cuda_device))
    b = _batches(cuda_device)[0]
    for _ in range(3):  # the eager warm-up and capture, then two replays
        before = [g.get_state() for g in gens]
        aux, _ = runner(b, False)
        assert torch.isfinite(aux["loss"])
        assert all(not torch.equal(g.get_state(), s) for g, s in zip(gens, before))


@pytest.mark.parametrize("length", [L, BOOK_L])
def test_replays_equal_eager_steps_with_dropout_and_drawn_coins(cuda_device, length):
    models, steps, opts, acc, gens = _setup(cuda_device, "float32", 0.1, length)
    scale = torch.full((), 0.5, device=cuda_device)
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, scale)
    batches = _batches(cuda_device, length)
    runner(batches[0], True)  # each branch: an eager warm-up step, then its capture
    runner(batches[1], False)
    assert sorted(runner.graphs) == [False, True]
    # the state both runs start from, restored in place (the graphs hold
    # these tensors' addresses)
    state = _params(models) + acc + [t for o in opts for st in o.adam.state.values()
                                     for t in st.values() if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in state]
    saved_gens = [g.get_state() for g in gens]

    def run(graphed, gen_states):
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        for g, s in zip(gens, gen_states):
            g.set_state(s)
        losses = []
        for i, b in enumerate(batches[2:]):
            do_apply = i % 4 == 0
            aux, d_loss = (runner(b, do_apply) if graphed
                           else steps.fused_step(b, acc, do_apply, *gens, scale))
            losses.append(torch.stack([aux["loss"], aux["BK"], aux["COPY"], d_loss]).clone())
        torch.cuda.synchronize()
        n = len(_params(models))
        return (torch.stack(losses), [t.detach().clone() for t in state[:n]],
                [a.clone() for a in acc], [g.get_state() for g in gens])

    l0, p0, a0, g0 = run(False, saved_gens)
    l1, p1, a1, g1 = run(True, saved_gens)
    assert torch.isfinite(l0).all()
    assert float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max()) <= TOL["float32"][0]
    move = _mean_abs(p0, saved[:len(p0)])
    assert move > 1e-5  # the run moved the parameters
    assert _mean_abs(p1, p0) <= TOL["float32"][1] * move
    assert _mean_abs(a1, a0) <= TOL["float32"][1] * float(
        torch.cat([a.abs().flatten() for a in a0]).mean())
    # the replays moved both generators on exactly as far as the eager steps
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))
    # and what they draw matters: replays from other generator states give
    # other losses
    l2, *_ = run(True, g0)
    assert float(((l2 - l0).abs() / l0.abs().clamp_min(1e-6)).max()) > 1e-3
