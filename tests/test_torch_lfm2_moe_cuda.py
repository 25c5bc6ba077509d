"""The LFM2-8B-A1B backbone on the card: the optimize stage's graphed step
(``train/optimize.py::GraphedFusedStep``) against the eager ``fused_step``
at a tiny width. Every test needs a CUDA device and skips without one.
This file imports no JAX, so it runs on a machine that has only PyTorch
(tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lfm2_moe_cuda.py

In bfloat16, the expert layer's one path on the card (sorted rows,
``torch._grouped_mm``, the combine by the inverse permutation), replays
give the eager steps' bits: the losses, G's parameters and Adam state, the
generators' states, and D's parameters while D is not applied (D's bf16
weight gradients differ in their last bits between the two). An eager step runs under
``torch.cuda.set_sync_debug_mode("error")``, so a host sync anywhere in it
raises, and the captured step replays, adding its grouped products to
``grouped_swiglu.launches`` and its routed rows to each layer's ``load``.
In float32 the expert layer raises on the card.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    Lfm2MoeGenerator,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.models.lfm2_moe import Cast  # noqa: E402
from consistent__style_transfer_torch.models.moe import SparseMoE, grouped_swiglu  # noqa: E402
from consistent__style_transfer_torch.train.optimize import (  # noqa: E402
    GraphedFusedStep,
    make_optimize_steps,
)
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402

pytestmark = pytest.mark.cuda
V, B, L, STEPS = 64, 8, 6, 6
SIZE = dict(d_model=32, n_heads=2, n_layers=2)
G_SIZE = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, d_expert=32,
              n_experts=8, top_k=4, n_dense=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(device, dtype, p_drop=0.1):
    cfg = make_config("tiny", device="cuda", dtype=dtype, max_len=L, p_drop=p_drop,
                      backbone="lfm2_moe", lfm2_layers=4)
    models = SimpleNamespace(
        generator=Lfm2MoeGenerator(V, 2, L, p_drop=p_drop, seed=1, n_layers=4, **G_SIZE),
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


def _batches(device, n):
    rng = np.random.default_rng(0)
    return [{"x": torch.from_numpy(rng.integers(3, V, (B, L)).astype(np.int32)).to(device),
             "labels": torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)}
            for _ in range(n)]


@pytest.mark.parametrize("apply", [(False,) * STEPS, (True,)], ids=["d_held", "d_apply"])
def test_bfloat16_replays_equal_eager_steps_bit_for_bit(cuda_device, apply):
    """Both branches captured first; then the parameters, both Adam states,
    the accumulator and the generators' states are saved, and the eager
    steps and the replays each start from them, dropout on: 6 steps of the
    D-held branch, or one of the D-apply branch. Held bit for bit: the
    losses, G's parameters and Adam state, the generators' states, and D's
    parameters where D is not applied. Not held: D's weight-gradient sum,
    whose bf16 backward differs in its last bits between an eager step and
    a replay (eager steps repeat it bit for bit), and so D after an apply;
    G's steps, which go through D's forward and its input gradient, do
    not read it."""
    models, steps, opts, acc, gens = _setup(cuda_device, "bfloat16")
    scale = torch.ones((), device=cuda_device)
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, scale)
    batches = _batches(cuda_device, len(apply) + 2)
    runner(batches[0], True)
    runner(batches[1], False)
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
        for do_apply, b in zip(apply, batches[2:]):
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


def test_bfloat16_step_makes_no_host_sync_and_replays(cuda_device):
    models, steps, opts, acc, gens = _setup(cuda_device, "bfloat16")
    scale = torch.ones((), device=cuda_device)
    batches = _batches(cuda_device, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps.fused_step(batches[0], acc, True, *gens, scale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, scale)
    runner(batches[1], False)  # the eager first call, then the capture
    moes = [m for m in models.generator.modules() if isinstance(m, SparseMoE)]
    for m in moes:
        m.load.zero_()
    launches = grouped_swiglu.launches
    aux, _ = runner(batches[2], False)
    torch.cuda.synchronize()
    captured = runner.replay_launches[False]
    n = dict((k.__name__, v) for k, v in captured)["grouped_swiglu"]
    assert n > 0 and grouped_swiglu.launches - launches == n
    assert torch.isfinite(aux["loss"])
    # rows a step: 3 MoE layers, top 4, over the G decode (2L positions), the
    # back-translation pass (2L) and D's decode (2L)
    assert [int(m.load.sum()) for m in moes] == [3 * 2 * L * B * 4] * len(moes)


def test_float32_expert_layer_raises_on_the_card(cuda_device):
    moe = SparseMoE(G_SIZE["d_model"], G_SIZE["d_expert"], G_SIZE["n_experts"],
                    G_SIZE["top_k"]).to(cuda_device)
    moe.reset_parameters_from(torch.Generator(cuda_device).manual_seed(0))
    x = torch.randn(5, G_SIZE["d_model"], device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        moe(x, Cast(torch.float32))
