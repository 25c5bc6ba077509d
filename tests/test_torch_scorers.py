"""The three pretrain scorers against the JAX package's, on the CPU in
float32: JAX-initialised weights go through the port's
``*_state_dict_from_jax`` (whose keys must equal the JAX exporter's), then
both packages score the same numpy inputs in eval mode, through the id path
and the soft-input path. Outputs within 1e-4 (the same float32 products,
summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.models import PairMatcher as JaxMatcher  # noqa: E402
from consistent__style_transfer_tpu.models import TextCNN as JaxTextCNN  # noqa: E402
from consistent__style_transfer_tpu.models import TransformerLM as JaxLM  # noqa: E402
from consistent__style_transfer_tpu.utils import torch_interop  # noqa: E402
from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM  # noqa: E402
from consistent__style_transfer_torch.utils import interop  # noqa: E402

V, B, L, LN = 37, 3, 7, 10
SIZE = dict(d_model=16, n_heads=2, n_layers=6)  # 6 layers: the JAX exporter's count
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _soft(seed, shape):
    logits = np.random.default_rng(seed).normal(size=(*shape, V))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _port(cls, params, to_sd, **kw):
    model = cls(V, **kw).eval()
    model.load_state_dict(to_sd(params), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def classifier():
    jm = JaxTextCNN(n_vocab=V, n_class=2)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.zeros((2, L), jnp.int32)))
    return jm, params, _port(TextCNN, params, interop.classifier_state_dict_from_jax)


@pytest.fixture(scope="module")
def matcher():
    jm = JaxMatcher(n_vocab=V, **SIZE)
    x0 = jnp.zeros((2, LN), jnp.int32)
    params = _np(jm.init(jax.random.PRNGKey(2), x0, x0))
    return jm, params, _port(PairMatcher, params, interop.matcher_state_dict_from_jax, **SIZE)


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(n_vocab=V, **SIZE)
    params = _np(jm.init(jax.random.PRNGKey(3), jnp.zeros((2, L), jnp.int32)))
    return jm, params, _port(TransformerLM, params, interop.lm_state_dict_from_jax, **SIZE)


@pytest.mark.parametrize("kind", ["classifier", "matcher", "lm"])
def test_keys_equal_the_jax_exporter(kind, request):
    _, params, model = request.getfixturevalue(kind)
    want = getattr(torch_interop, f"{kind}_to_state_dict")(params)
    got = getattr(interop, f"{kind}_state_dict_from_jax")(params)
    assert sorted(got) == sorted(want)
    assert sorted(model.state_dict()) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_classifier_ids_and_soft(classifier):
    jm, params, model = classifier
    x, s = _ids(4, (B, L)), _soft(5, (B, L))
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x)).numpy(), np.asarray(jm.apply(params, x)), **TOL)
        np.testing.assert_allclose(model(_t(s)).numpy(), np.asarray(jm.apply(params, s)), **TOL)
        tm = s.transpose(1, 0, 2)  # (L, B, V) soft stacks
        np.testing.assert_allclose(model(_t(tm), time_major=True).numpy(),
                                   np.asarray(jm.apply(params, tm, time_major=True)), **TOL)


def test_matcher_ids_and_soft(matcher):
    jm, params, model = matcher
    x1, x2, s1 = _ids(6, (B, LN)), _ids(7, (B, LN - 3)), _soft(8, (B, LN))
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x1), _t(x2)).numpy(),
                                   np.asarray(jm.apply(params, x1, x2)), **TOL)
        np.testing.assert_allclose(model(_t(s1), _t(x2)).numpy(),
                                   np.asarray(jm.apply(params, s1, x2)), **TOL)
        tm = s1.transpose(1, 0, 2)
        np.testing.assert_allclose(model(_t(tm), _t(x2), time_major=True).numpy(),
                                   np.asarray(jm.apply(params, tm, x2, time_major=True)), **TOL)


def test_lm_ids_and_soft(lm):
    jm, params, model = lm
    x, s = _ids(9, (B, L)), _soft(10, (B, L))
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x)).numpy(), np.asarray(jm.apply(params, x)), **TOL)
        np.testing.assert_allclose(model(_t(s)).numpy(), np.asarray(jm.apply(params, s)), **TOL)


def test_train_mode_dropout_follows_the_generator(lm):
    """Dropout is on in train mode, drawn from the given generator: the same
    seed gives the same output, another seed another, eval mode none."""
    _, params, model = lm
    x = _t(_ids(11, (B, L)))
    model.train()
    try:
        a = model(x, torch.Generator().manual_seed(1))
        b = model(x, torch.Generator().manual_seed(1))
        c = model(x, torch.Generator().manual_seed(2))
    finally:
        model.eval()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, model(x))


@pytest.mark.parametrize("cls, kw", [(TextCNN, {}), (PairMatcher, SIZE), (TransformerLM, SIZE)],
                         ids=["classifier", "matcher", "lm"])
def test_fresh_weights_have_the_jax_distributions(cls, kw):
    """Fresh port weights are a function of the seed, and each tensor's
    spread is within 15% of the same tensor's under the JAX init."""
    a, b = cls(V, seed=3, **kw), cls(V, seed=3, **kw)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    jax_cls = {TextCNN: JaxTextCNN, PairMatcher: JaxMatcher, TransformerLM: JaxLM}[cls]
    exporter = {TextCNN: "classifier", PairMatcher: "matcher", TransformerLM: "lm"}[cls]
    x0 = jnp.zeros((2, L), jnp.int32)
    args = (x0, x0) if cls is PairMatcher else (x0,)
    params = _np(jax_cls(n_vocab=V, **kw).init(jax.random.PRNGKey(0), *args))
    want = getattr(torch_interop, f"{exporter}_to_state_dict")(params)
    for k, v in a.state_dict().items():
        ref = np.asarray(want[k])
        if ref.size > 1 and ref.std() == 0:  # zeros and ones (in_proj bias, LayerNorm)
            np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
        elif v.numel() >= 200:
            assert v.std().item() == pytest.approx(float(ref.std()), rel=0.15), k
