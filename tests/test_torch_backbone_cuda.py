"""The transformer backbone on the card: the optimize stage's graphed step
(``train/optimize.py::GraphedFusedStep``, every optimize step of
``run_optimize`` on the card) against the eager ``fused_step`` at a tiny
width, and the card's beam decode against the CPU's. Every test needs a
CUDA device and skips without one. This file imports no JAX, so it runs on
a machine that has only PyTorch (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_backbone_cuda.py

Tolerances (those of tests/test_torch_megastep_cuda.py in float32): losses
within 1e-5 relative; the mean absolute difference of the parameters within
1e-3 of their mean absolute move, and of the accumulator within 1e-3 of its
mean absolute entry. Beam ids equal, scores within 1e-4 (float32 on two
devices, sums of 5 log-probs).
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
    TransformerSeq2Seq,
)
from consistent__style_transfer_torch.models.beam import beam_decode_any  # noqa: E402
from consistent__style_transfer_torch.train.optimize import (  # noqa: E402
    GraphedFusedStep,
    make_optimize_steps,
)
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402

pytestmark = pytest.mark.cuda
V, B, L, STEPS = 60, 8, 6, 9
SIZE = dict(d_model=32, n_heads=2, n_layers=2)
G_SIZE = dict(d_model=32, n_heads=4, n_enc=2, n_dec=2, d_ff=64)
LOSS_REL, SHARE = 1e-5, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(device, p_drop):
    cfg = make_config("tiny", device="cuda", dtype="float32", max_len=L, p_drop=p_drop,
                      backbone="transformer", w_copy=0.5)
    models = SimpleNamespace(
        generator=TransformerSeq2Seq(V, 2, L, p_drop=p_drop, seed=1, **G_SIZE),
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


def _batches(device, n=STEPS):
    rng = np.random.default_rng(0)
    return [{"x": torch.from_numpy(rng.integers(3, V, (B, L)).astype(np.int32)).to(device),
             "labels": torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)}
            for _ in range(n)]


@pytest.mark.parametrize("p_drop", [0.0, 0.1], ids=["dropout_off", "dropout_on"])
def test_transformer_graph_replays_equal_eager_steps(cuda_device, p_drop):
    """Both branches captured first; then the parameters, both Adam states,
    the accumulator and the generators' states are saved, and 9 eager steps
    and 9 replays each start from them (D every 4th), all in float32 (the
    transformer computes in float32 whatever the dtype; under the scorers'
    bf16 autocast a product summed in another order on the capture stream
    moves a loss by about 3e-5 relative, measured on an H100, so bf16 is
    not held to these bounds)."""
    models, steps, opts, acc, gens = _setup(cuda_device, p_drop)
    scale = torch.full((), 0.5, device=cuda_device)
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, scale)
    batches = _batches(cuda_device, STEPS + 2)
    runner(batches[0], True)
    runner(batches[1], False)
    assert sorted(runner.graphs) == [False, True]
    state = _params(models) + acc + [t for o in opts for st in o.adam.state.values()
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
        for i, b in enumerate(batches[2:]):
            do_apply = i % 4 == 0
            aux, d_loss = (runner(b, do_apply) if graphed
                           else steps.fused_step(b, acc, do_apply, *gens, scale))
            losses.append(torch.stack([aux["loss"], aux["BK"], aux["COPY"], d_loss]).clone())
        torch.cuda.synchronize()
        n = len(_params(models))
        return (torch.stack(losses), [t.detach().clone() for t in state[:n]],
                [a.clone() for a in acc], [g.get_state() for g in gens])

    l0, p0, a0, g0 = run(False)
    l1, p1, a1, g1 = run(True)
    assert torch.isfinite(l0).all()
    assert float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max()) <= LOSS_REL
    move = _mean_abs(p0, saved[:len(p0)])
    assert move > 1e-5
    assert _mean_abs(p1, p0) <= SHARE * move
    assert _mean_abs(a1, a0) <= SHARE * float(torch.cat([a.abs().flatten() for a in a0]).mean())
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))


@pytest.mark.parametrize("backbone", ["lstm", "transformer"])
def test_beam_on_the_card_equals_the_cpu(cuda_device, backbone):
    """float32, the same weights: ids equal, scores within 1e-4."""
    if backbone == "lstm":
        model = DenoiseSeq2Seq(V, 2, L, seed=3)
    else:
        model = TransformerSeq2Seq(V, 2, L, seed=3, **G_SIZE)
    model.eval()
    b = _batches(torch.device("cpu"), 1)[0]
    out = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        x, li = b["x"].to(dev), b["labels"].to(dev)
        out[dev] = [t.cpu() for t in beam_decode_any(m, x, li, 1 - li, beam_size=4)]
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)
