"""The generator's training modes against the JAX package's
``DenoiseSeq2Seq`` on the same weights, on the CPU in float32: ``sched`` with
a teacher and given coins, ``teacher``, ``st`` probs, soft encoder input,
``time_major_out`` and the gradient of a scalar through the ``st`` rollout;
and the port's dropout (seeded, off in eval).

Dropout is off on both sides where numbers are compared: the JAX module's
``p_drop`` field is 0 and the port's module is in eval mode or built with
``p_drop=0``. The JAX package draws its sched coins inside the module from
the "coin" rng; the tests replace ``jax.random.bernoulli`` for the call (a
test-side patch) so that the JAX call uses the coins that the port is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq, sched_coins  # noqa: E402
from consistent__style_transfer_torch.ops.sampling import hard_sample_st  # noqa: E402
from consistent__style_transfer_torch.utils.interop import generator_state_dict_from_jax  # noqa: E402

V, B, L = 50, 4, 6
# f32 logits and probs: the two frameworks sum the products in other orders
# (about 1e-7 apart); 1e-5 leaves two orders of magnitude
ATOL = 1e-5
COINS = np.array([1, 0, 0, 1, 1, 0], bool)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU ops: the test workers share the
    cores, and several torch thread pools spinning on them slow every worker
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((2, L), jnp.int32)
    lab = jnp.zeros((2,), jnp.int32)
    params = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L).init(
        jax.random.PRNGKey(0), x, lab, x, lab, deterministic=True)
    return jax.tree.map(np.asarray, jax.device_get(params))


@pytest.fixture
def jax_coins(monkeypatch):
    """The JAX module's sched coins are ``COINS``."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(COINS[: shape[0]]))


def _port(jax_params, p_drop=0.0):
    model = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=p_drop)
    model.load_state_dict(generator_state_dict_from_jax(jax_params), strict=True)
    return model


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(3, V, (B, L)).astype(np.int32)
    inp = rng.integers(3, V, (B, L)).astype(np.int32)
    labels = np.array([0, 1, 1, 0], np.int32)
    return inp, x, labels


def _jax(jax_params, inp, labels, x, mode, **kw):
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
    out = model.apply(jax_params, jnp.asarray(inp), jnp.asarray(labels),
                      None if x is None else jnp.asarray(x), jnp.asarray(1 - labels), mode=mode,
                      deterministic=True, rngs={"coin": jax.random.PRNGKey(1)}, **kw)
    return np.asarray(out)


def _torch(model, inp, labels, x, mode, **kw):
    with torch.no_grad():
        return model(torch.as_tensor(inp), torch.as_tensor(labels),
                     None if x is None else torch.as_tensor(x), torch.as_tensor(1 - labels),
                     mode=mode, **kw).numpy()


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train_p0"])
def test_sched_with_teacher_and_given_coins_matches_jax(jax_params, jax_coins, train_mode):
    """Coin 1 feeds the teacher token, 0 the greedy one; in train mode with
    p_drop=0 the numbers are the same as in eval mode."""
    inp, x, labels = _inputs(1)
    want = _jax(jax_params, inp, labels, x, "sched")
    model = _port(jax_params).train(train_mode)
    got = _torch(model, inp, labels, x, "sched", coins=torch.from_numpy(COINS))
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sched_coins_pick_teacher_or_greedy(jax_params):
    """All coins 1 is the teacher mode, all 0 the greedy feed of sched with
    x=None; mixed coins differ from both. One coin a step for the batch."""
    inp, x, labels = _inputs(2)
    model = _port(jax_params).eval()
    ones, zeros = torch.ones(L, dtype=torch.bool), torch.zeros(L, dtype=torch.bool)
    teacher = _torch(model, inp, labels, x, "teacher")
    np.testing.assert_array_equal(_torch(model, inp, labels, x, "sched", coins=ones), teacher)
    free = _torch(model, inp, labels, None, "sched")
    np.testing.assert_array_equal(_torch(model, inp, labels, x, "sched", coins=zeros), free)
    mixed = _torch(model, inp, labels, x, "sched", coins=torch.from_numpy(COINS))
    assert np.abs(mixed - teacher).max() > 1e-4 and np.abs(mixed - free).max() > 1e-4
    c = sched_coins(1000, torch.Generator().manual_seed(0), "cpu")
    assert c.shape == (1000,) and c.dtype == torch.bool and 400 < int(c.sum()) < 600


def test_teacher_mode_matches_jax(jax_params):
    inp, x, labels = _inputs(3)
    want = _jax(jax_params, inp, labels, x, "teacher")
    got = _torch(_port(jax_params).eval(), inp, labels, x, "teacher")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tau", [0.1, 1.0])
def test_st_probs_match_jax(jax_params, tau):
    """st decode (x=None, max_len steps): probs within 1e-5; the fed-back
    straight-through samples are the same tokens on both sides."""
    inp, _, labels = _inputs(4)
    want = _jax(jax_params, inp, labels, None, "st", tau=tau)
    got = _torch(_port(jax_params).eval(), inp, labels, None, "st", tau=tau)
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_soft_encoder_input_matches_jax(jax_params, jax_coins):
    """Soft (B, L, V) encoder input is hard_sample_st(inp) @ table."""
    rng = np.random.default_rng(5)
    soft = rng.dirichlet(np.ones(V), (B, L)).astype(np.float32)
    _, x, labels = _inputs(5)
    want = _jax(jax_params, soft, labels, x, "sched")
    got = _torch(_port(jax_params).eval(), soft, labels, x, "sched",
                 coins=torch.from_numpy(COINS))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the same as feeding the argmax ids
    ids = _torch(_port(jax_params).eval(), soft.argmax(-1), labels, x, "sched",
                 coins=torch.from_numpy(COINS))
    np.testing.assert_allclose(got, ids, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["st", "sched"])
def test_time_major_out_matches_jax(jax_params, jax_coins, mode):
    inp, x, labels = _inputs(6)
    teacher = x if mode == "sched" else None
    kw = {"coins": torch.from_numpy(COINS)} if mode == "sched" else {}
    want = _jax(jax_params, inp, labels, teacher, mode, time_major_out=True)
    model = _port(jax_params).eval()
    got = _torch(model, inp, labels, teacher, mode, time_major_out=True, **kw)
    assert got.shape == (L, B, V) and want.shape == (L, B, V)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    batch_major = _torch(model, inp, labels, teacher, mode, **kw)
    np.testing.assert_array_equal(got, batch_major.transpose(1, 0, 2))


def test_st_gradient_matches_jax_grad(jax_params):
    """d/dparams of sum(w * probs) through the whole st rollout (the
    straight-through feedback reaches the probs and the table): each
    parameter's gradient within 1e-4 of its largest entry."""
    inp, _, labels = _inputs(7)
    w = np.random.default_rng(8).normal(size=(B, L, V)).astype(np.float32)
    model_j = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)

    def scalar(p):
        probs = model_j.apply(p, jnp.asarray(inp), jnp.asarray(labels), None,
                              jnp.asarray(1 - labels), mode="st", tau=0.5, deterministic=True)
        return jnp.sum(probs * w)

    want = generator_state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(scalar)(jax_params)))
    model = _port(jax_params).eval()
    probs = model(torch.from_numpy(inp), torch.from_numpy(labels), None,
                  torch.from_numpy(1 - labels), mode="st", tau=0.5)
    (probs * torch.from_numpy(w)).sum().backward()
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for k, g in want.items():
        scale = float(g.abs().max())
        err = float((named[k].grad - g).abs().max())
        assert err <= 1e-4 * scale + 1e-9, f"{k}: max abs err {err} vs 1e-4 x {scale}"
    # the table's gradient has a part through the straight-through feedback
    assert named["token_embedding.weight"].grad.abs().max() > 0


def test_hard_sample_st_forward_and_gradient():
    p = torch.softmax(torch.randn(3, 7, generator=torch.Generator().manual_seed(0)), -1)
    p.requires_grad_(True)
    h = hard_sample_st(p)
    np.testing.assert_array_equal(h.detach().numpy(),
                                  np.eye(7, dtype=np.float32)[p.argmax(-1).numpy()])
    w = torch.randn(3, 7)
    (h * w).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), w.numpy())  # identity going back


def test_dropout_reproducible_from_generator_and_off_in_eval(jax_params, jax_coins):
    """Train mode: the same seed gives the same masks, another seed other
    masks. Eval mode: no dropout, whatever the generator (the JAX package's
    deterministic output)."""
    inp, x, labels = _inputs(9)
    model = _port(jax_params, p_drop=0.1)

    def run(seed, train):
        model.train(train)
        return _torch(model, inp, labels, x, "sched", coins=torch.from_numpy(COINS),
                      generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0, True), run(0, True), run(1, True)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-4
    want = _jax(jax_params, inp, labels, x, "sched")
    for seed in (0, 1):
        np.testing.assert_allclose(run(seed, False), want, atol=ATOL, rtol=0)
    assert np.abs(a - want).max() > 1e-4
