"""The LSTM generator's one weight cast a call (``DenoiseSeq2Seq.one_cast``,
``models/weight_cast.py``) on the CPU, against the per-timestep path that
the same model takes with ``one_cast`` replaced by a null context: bf16
autocast then recasts every float32 master weight at every product, as it
does inside a CUDA-graph capture (``cache_enabled=False``).

- forward: ``st``, ``sched`` (given coins), ``teacher`` and ``gumbel``
  outputs are bit-identical, dropout on;
- gradients: each parameter's gradient is no further from the float64
  weight gradient of the same graph than the per-timestep path's, nor than
  the eager path's (autocast's cached casts, whose gradients autograd sums
  in bf16). The float64 gradient is the same run with each pass's weight
  gradient formed in float64 from the products' own inputs and output
  gradients, which both paths share bit for bit;
- passthrough: float32 models and bf16-parameter models decode alike with
  and without the scope, and it casts nothing there;
- the optimize stage's steps: ``generator.weight_casts`` counts 34 a fused
  step (the G step's scope and D's decode), 17 a validation step, 0 in
  float32.
"""

import contextlib
from types import SimpleNamespace

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
from consistent__style_transfer_torch.models import weight_cast  # noqa: E402
from consistent__style_transfer_torch.train.optimize import make_optimize_steps  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import profiling  # noqa: E402

V, B, L = 50, 4, 6
COINS = torch.tensor([1, 0, 0, 1, 1, 0], dtype=torch.bool)
MODES = ("st", "sched", "teacher", "gumbel")
BF16 = torch.bfloat16
COUNTER = "generator.weight_casts"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def casts(monkeypatch):
    """The counter's events, recorded for the test."""
    monkeypatch.setattr(profiling.RECORDER, "env", True)
    profiling.RECORDER.clear()
    yield lambda: sum(n for name, _, n in profiling.RECORDER.counters if name == COUNTER)
    profiling.RECORDER.clear()


def _null_scope(monkeypatch):
    monkeypatch.setattr(DenoiseSeq2Seq, "one_cast", lambda self: contextlib.nullcontext())


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(3, V, (B, L), generator=g)
    inp = torch.randint(3, V, (B, L), generator=g)
    return inp, x, torch.tensor([0, 1, 1, 0])


def _decode(model, mode, autocast, seed=0):
    """The decode's output and the gradients of a fixed random projection of
    it, dropout on, its masks (and Gumbel noise) from a generator seeded
    ``seed``."""
    inp, x, labels = _inputs()
    model.zero_grad()
    with autocast:
        out = model(inp, labels, None if mode in ("st", "gumbel") else x, 1 - labels, mode=mode,
                    generator=torch.Generator().manual_seed(seed), coins=COINS)
    proj = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    (out.float() * proj).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}


def _f64_gradients(self):
    """``Uses.gradients`` in float64 (autograd rounds each to the float32
    master once)."""
    X = torch.cat([x.reshape(-1, x.shape[-1]) for x, _ in self.grads]).double()
    dY = torch.cat([dy.reshape(-1, dy.shape[-1]) for _, dy in self.grads]).double()
    self.grads = []
    dw = X.t() @ dY if self.transposed else dY.t() @ X
    return dw, None if self.b is None else dY.sum(0)


def _rel(a, ref):
    return float((a.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_forward_is_bit_identical_to_the_per_timestep_path(monkeypatch, casts, mode):
    model = DenoiseSeq2Seq(V, 2, L, seed=1).train()
    ac = torch.autocast("cpu", dtype=BF16, cache_enabled=False)
    got, _ = _decode(model, mode, ac)
    assert casts() == 17
    with monkeypatch.context() as m:
        _null_scope(m)
        want, _ = _decode(model, mode, torch.autocast("cpu", dtype=BF16, cache_enabled=False))
    assert casts() == 17  # the nulled scope casts nothing
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("cache", [False, True], ids=["per_timestep", "autocast_cache"])
@pytest.mark.parametrize("mode", MODES)
def test_gradients_are_no_further_from_float64(monkeypatch, mode, cache):
    model = DenoiseSeq2Seq(V, 2, L, seed=1).train()
    _, ours = _decode(model, mode, torch.autocast("cpu", dtype=BF16, cache_enabled=False))
    with monkeypatch.context() as m:
        m.setattr(weight_cast.Uses, "gradients", _f64_gradients)
        _, ref = _decode(model, mode, torch.autocast("cpu", dtype=BF16, cache_enabled=False))
    with monkeypatch.context() as m:
        _null_scope(m)
        _, old = _decode(model, mode, torch.autocast("cpu", dtype=BF16, cache_enabled=cache))
    assert ours.keys() == ref.keys() == old.keys()
    products = {id(p) for p in model.product_weights()}
    for name, p in model.named_parameters():
        if name not in ref:
            continue
        e_ours, e_old = _rel(ours[name], ref[name]), _rel(old[name], ref[name])
        assert e_ours <= e_old, (name, e_ours, e_old)
        if id(p) in products:
            # float32 sums of the steps' products, against bf16 roundings
            assert e_ours < 1e-5, (name, e_ours)


@pytest.mark.parametrize("params, autocast", [(torch.float32, None), (BF16, None), (BF16, BF16)],
                         ids=["float32", "bf16_params", "bf16_params_autocast"])
@pytest.mark.parametrize("mode", MODES)
def test_no_cast_where_the_weights_are_in_the_compute_dtype(monkeypatch, casts, params,
                                                            autocast, mode):
    model = DenoiseSeq2Seq(V, 2, L, seed=1).to(params).train()

    def ctx():
        return (contextlib.nullcontext() if autocast is None
                else torch.autocast("cpu", dtype=autocast, cache_enabled=False))

    with ctx(), model.one_cast():
        got, _ = _decode(model, mode, contextlib.nullcontext())
    with monkeypatch.context() as m:
        _null_scope(m)
        with ctx():
            want, _ = _decode(model, mode, contextlib.nullcontext())
    assert casts() == 0
    assert torch.equal(got, want)


def _optimize(dtype):
    cfg = make_config("tiny", device="cpu", dtype=dtype, max_len=L, p_drop=0.1)
    size = dict(d_model=32, n_heads=2, n_layers=1)
    models = SimpleNamespace(
        generator=DenoiseSeq2Seq(V, 2, L, seed=1).train(), classifier=TextCNN(V, seed=2),
        matcher=PairMatcher(V, seed=3, **size), nt_checker=TransformerLM(V, seed=4, **size),
        disc=RelGANDiscriminator(V, seed=5))
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    steps = make_optimize_steps(cfg, models, AdamWithClip(models.generator.parameters(), 1e-3, 1.0),
                                AdamWithClip(models.disc.parameters(), 1e-3, 1.0))
    return models, steps


@pytest.mark.parametrize("dtype, per_step, per_val", [("bfloat16", 34, 17), ("float32", 0, 0)])
@pytest.mark.parametrize("do_apply", [False, True], ids=["d_held", "d_apply"])
def test_optimize_steps_count_their_casts(casts, dtype, per_step, per_val, do_apply):
    models, steps = _optimize(dtype)
    _, x, labels = _inputs()
    batch = {"x": x.int(), "labels": labels.int()}
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    before = [p.detach().clone() for p in models.generator.parameters()]
    steps.fused_step(batch, acc, do_apply, torch.Generator().manual_seed(0),
                     torch.Generator().manual_seed(1), coins=COINS)
    assert casts() == per_step
    assert all(torch.isfinite(p).all() for p in models.generator.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(before, models.generator.parameters()))
    steps.val_step(batch)
    assert casts() == per_step + per_val
