"""The LFM2-8B-A1B generator's weight gradients under one cast scope
(``CastScope.one_cast``, ``models/weight_cast.py``, ``models/moe.py``) on
the CPU under bf16 autocast, at a narrow width with the cell's layer mix:
8 layers, 2 dense and 6 with experts. One optimize G step's two calls
(the ``st`` decode, then the back-translation ``sched`` pass) run in one
scope, as ``train/optimize.py``'s G step runs them.

Against the one-copy path: the same scope with each copy made by an
autograd cast (``p.to(dtype)``) and every product reading it plainly, so
autograd sums each copy's gradient over the scope's calls in bf16 (what
the generator did before its products went through ``Uses`` and
``ExpertUses``):

- forward: the two calls' outputs are bit-identical;
- gradients: each parameter's gradient is no further from a float64
  gather of the same products (the stashed rows and output gradients,
  which both paths share bit for bit) than the one-copy path's. The dense
  weights' are float32 sums; the expert weights' one bf16 rounding of a
  float32 sum; the parameters that no product reads get the same bits;
- counters: ``moe.grad_gathers`` counts one gather an expert layer a G
  step (6), none under ``no_grad`` and none in the optimize stage's D
  decode or validation; ``moe.grad_rows`` and the stash count each routed
  row of the scope once, though every layer is checkpointed and runs
  again in the backward.
"""

from types import SimpleNamespace

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
from consistent__style_transfer_torch.models import moe, weight_cast  # noqa: E402
from consistent__style_transfer_torch.train.optimize import make_optimize_steps  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import profiling  # noqa: E402

V, B, L, K, N_EXPERT_LAYERS = 40, 3, 5, 4, 6
WIDTHS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, d_expert=32,
              n_experts=8, top_k=K, n_dense=2)
BF16 = torch.bfloat16
# routed rows of one layer in a G step: the decode's source pass (B x L
# tokens) and L cached steps (B each), the teacher pass (B x 2L)
ROWS = 4 * B * L * K
SOURCE_ROWS = B * L * K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return Lfm2MoeGenerator(V, 2, L, p_drop=0.1, seed=3, n_layers=8, **WIDTHS).train()


def _autocast():
    return torch.autocast("cpu", dtype=BF16, cache_enabled=False)


def _g_step(model, grad: bool = True):
    """The two calls of an optimize G step in one scope, dropout on, and the
    gradients of a fixed random projection of both outputs: (outputs,
    gradients by name)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(3, V, (B, L), generator=g)
    labels = torch.tensor([0, 1, 1])
    model.zero_grad()
    with torch.set_grad_enabled(grad), _autocast(), model.one_cast():
        drop = torch.Generator().manual_seed(1)
        probs = model(x, labels, None, 1 - labels, mode="st", generator=drop)
        logits = model(probs.detach().argmax(-1), 1 - labels, x, labels, mode="sched",
                       generator=drop)
    outs = (probs.detach(), logits.detach())
    if not grad:
        return outs, {}
    proj = torch.Generator().manual_seed(7)
    loss = sum((o.float() * torch.randn(o.shape, generator=proj)).sum() for o in (probs, logits))
    loss.backward()
    return outs, {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _one_copy_path(m):
    """Each copy an autograd cast of its master, read by plain products, so
    autograd sums its gradient over the scope's calls in bf16."""
    real_init = weight_cast.WeightCast.__init__

    def init(self, params, dtype, counter):
        real_init(self, params, dtype, counter)
        self.copies = {id(p): p.to(dtype) for p in params}

    m.setattr(weight_cast.WeightCast, "__init__", init)
    m.setattr(weight_cast.WeightCast, "uses",
              lambda self, w, transposed=False: weight_cast.Uses(self[w], transposed=transposed))
    m.setattr(moe.ExpertUses, "__call__",
              lambda self, xs, ends: moe.grouped_swiglu(xs, ends, self.w1, self.w3, self.w2))


def _f64_dense(self):
    """``Uses.gradients`` in float64."""
    X = torch.cat([x.reshape(-1, x.shape[-1]) for x, _ in self.grads]).double()
    dY = torch.cat([dy.reshape(-1, dy.shape[-1]) for _, dy in self.grads]).double()
    self.grads = []
    return (X.t() @ dY if self.transposed else dY.t() @ X), None


def _f64_experts(self):
    """``ExpertUses.gradients`` in float64: each expert's rows of each call,
    summed over the calls."""
    w1, w3, w2 = (torch.zeros(w.shape, dtype=torch.float64) for w in (self.w1, self.w3, self.w2))
    for xs, ends, h, da, db, dy in self.stash:
        start = 0
        for e, end in enumerate(ends.tolist()):
            x, hh = xs[start:end].double(), h[start:end].double()
            w1[e] += da[start:end].double().t() @ x
            w3[e] += db[start:end].double().t() @ x
            w2[e] += dy[start:end].double().t() @ hh
            start = end
    self.stash = []
    return w1, w3, w2


def _rel(a, ref):
    return float((a.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30))


def test_forward_is_bit_identical_to_the_one_copy_path(monkeypatch):
    model = _model()
    ours, _ = _g_step(model)
    with monkeypatch.context() as m:
        _one_copy_path(m)
        want, _ = _g_step(model)
    for got, ref in zip(ours, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


def test_gradients_are_no_further_from_float64(monkeypatch):
    model = _model()
    _, ours = _g_step(model)
    with monkeypatch.context() as m:
        m.setattr(weight_cast.Uses, "gradients", _f64_dense)
        m.setattr(moe.ExpertUses, "gradients", _f64_experts)
        _, ref = _g_step(model)
    with monkeypatch.context() as m:
        _one_copy_path(m)
        _, old = _g_step(model)
    assert ours.keys() == ref.keys() == old.keys()
    experts = {id(w) for m in model.modules() if isinstance(m, moe.SparseMoE)
               for w in (m.w1, m.w3, m.w2)}
    products = {id(p) for p in model.product_weights()}
    assert len(experts) == 3 * N_EXPERT_LAYERS
    for name, p in model.named_parameters():
        e_ours, e_old = _rel(ours[name], ref[name]), _rel(old[name], ref[name])
        assert e_ours <= e_old, (name, e_ours, e_old)
        if id(p) in experts:
            assert e_ours <= 2 ** -8, (name, e_ours)  # one bf16 rounding
        elif id(p) in products:
            assert e_ours < 1e-5, (name, e_ours)  # float32 sums of the calls' products
        elif "conv_weight" not in name:
            # no product reads it: the rows' gradients are autograd's bits
            assert torch.equal(ours[name], old[name]), name


@pytest.fixture
def gathers(monkeypatch):
    """(stash entries, stacked rows) of each expert gather, in order."""
    seen = []
    real = moe.ExpertUses.gradients

    def record(self):
        seen.append((len(self.stash), sum(len(s[0]) for s in self.stash)))
        return real(self)

    monkeypatch.setattr(moe.ExpertUses, "gradients", record)
    return seen


def test_one_gather_an_expert_layer_a_step_and_each_row_once(gathers):
    model = _model()
    n, rows = profiling.total("moe.grad_gathers"), profiling.total("moe.grad_rows")
    _g_step(model)
    assert profiling.total("moe.grad_gathers") - n == N_EXPERT_LAYERS
    # each checkpointed layer's calls, once: the decode's L + 1 and the
    # teacher pass; but the last layer's source pass, whose output nothing
    # reads (the cached steps read its K and V alone), has no gradient
    want = [(L + 2, ROWS)] * (N_EXPERT_LAYERS - 1) + [(L + 1, ROWS - SOURCE_ROWS)]
    assert sorted(gathers) == sorted(want)
    assert profiling.total("moe.grad_rows") - rows == sum(r for _, r in want)
    n = profiling.total("moe.grad_gathers")
    _g_step(model, grad=False)
    assert profiling.total("moe.grad_gathers") == n and len(gathers) == N_EXPERT_LAYERS


def test_the_optimize_stage_gathers_in_its_g_step_alone():
    cfg = make_config("tiny", device="cpu", dtype="bfloat16", max_len=L, p_drop=0.1,
                      backbone="lfm2_moe", lfm2_layers=8)
    size = dict(d_model=32, n_heads=2, n_layers=1)
    models = SimpleNamespace(
        generator=_model(), classifier=TextCNN(V, seed=2), matcher=PairMatcher(V, seed=3, **size),
        nt_checker=TransformerLM(V, seed=4, **size), disc=RelGANDiscriminator(V, seed=5))
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    steps = make_optimize_steps(cfg, models,
                                AdamWithClip(models.generator.parameters(), 1e-3, 1.0),
                                AdamWithClip(models.disc.parameters(), 1e-3, 1.0))
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randint(3, V, (B, L), generator=g).int(),
             "labels": torch.tensor([0, 1, 1]).int()}
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    before = [p.detach().clone() for p in models.generator.parameters()]
    counts = ("moe.grad_gathers", "generator.weight_casts")
    n = {c: profiling.total(c) for c in counts}
    steps.fused_step(batch, acc, True, torch.Generator().manual_seed(0),
                     torch.Generator().manual_seed(1))
    casts = len(models.generator.product_weights())
    # the G step's scope and D's no-grad decode cast; the G step gathers
    assert {c: profiling.total(c) - n[c] for c in counts} == {
        "moe.grad_gathers": N_EXPERT_LAYERS, "generator.weight_casts": 2 * casts}
    assert all(torch.isfinite(p).all() for p in models.generator.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(before, models.generator.parameters()))
    steps.val_step(batch)
    assert profiling.total("moe.grad_gathers") - n["moe.grad_gathers"] == N_EXPERT_LAYERS
    assert profiling.total("generator.weight_casts") - n["generator.weight_casts"] == 3 * casts
