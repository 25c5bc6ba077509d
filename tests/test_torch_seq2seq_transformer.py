"""The port's transformer generator backbone
(``consistent__style_transfer_torch/models/seq2seq_transformer.py``) against
the JAX package's ``TransformerSeq2Seq`` on the same weights, carried across
by ``utils/interop.py::transformer_generator_state_dict_from_jax``, on the
CPU in float32, dropout off: teacher-forced logits, soft-input logits,
greedy ids, ``st`` probs and the gradient of a scalar of them, ``sched``
logits without a teacher; one case at the full T5-small widths.

The JAX module reads its widths from module constants at call time, so the
narrow cases set ``D_MODEL, N_HEADS, HEAD_DIM, N_ENC, N_DEC, D_FF`` for this
file's duration (a test-side patch, undone after the last test; nothing in
the JAX package's files changes).

Tolerances: logits, probs and gradients within 1e-5 of the largest entry of
the JAX tensor (float32, the same products summed in another order), ids
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import consistent__style_transfer_tpu.models.seq2seq_transformer as jax_tf  # noqa: E402
from consistent__style_transfer_torch.models import seq2seq_transformer as tf  # noqa: E402
from consistent__style_transfer_torch.models.seq2seq_transformer import (  # noqa: E402
    TransformerSeq2Seq,
    generate,
)
from consistent__style_transfer_torch.utils.interop import (  # noqa: E402
    transformer_generator_state_dict_from_jax,
)

V, B, L = 40, 3, 6
NARROW = dict(D_MODEL=32, N_HEADS=4, HEAD_DIM=8, N_ENC=2, N_DEC=2, D_FF=64)
FULL = {k: getattr(jax_tf, k) for k in NARROW}  # T5-small
PORT_NARROW = dict(d_model=32, n_heads=4, n_enc=2, n_dec=2, d_ff=64)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def narrow():
    """The JAX module narrowed for this file, a JAX model without dropout,
    its params and the port's model holding them (eval mode)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in NARROW.items():
            mp.setattr(jax_tf, k, v)
        jm = jax_tf.TransformerSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
        x, li = _inputs()
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x, li, None, li,
                                                  deterministic=True))
        pm = TransformerSeq2Seq(V, 2, L, p_drop=0.0, **PORT_NARROW).eval()
        pm.load_state_dict(transformer_generator_state_dict_from_jax(params), strict=True)
        yield jm, params, pm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, V, (B, L)).astype(np.int32), np.array([0, 1, 0], np.int32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= TOL * max(scale, 1.0), f"{msg}: max abs err {err} vs {TOL} x {scale}"


def test_state_dict_follows_the_flax_tree(narrow):
    """Every flax leaf has one port key of the same dotted path, and every
    port parameter one leaf: strict loading both ways (the fixture loads)."""
    _, params, pm = narrow
    sd = transformer_generator_state_dict_from_jax(params)
    assert sorted(sd) == sorted(pm.state_dict())
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves
    for key in ("enc_0.attn.q.weight", "dec_1.cross_attn.out.bias", "dec_1.ln3.weight",
                "lm_head.weight", "enc_norm.bias", "start_embedding.weight"):
        assert key in sd, key
    assert "lm_head.bias" not in sd
    np.testing.assert_array_equal(sd["enc_0.attn.q.weight"].numpy(),
                                  params["params"]["enc_0"]["attn"]["q"]["kernel"].T)


def test_teacher_forced_logits_match_jax(narrow):
    jm, params, pm = narrow
    x, li = _inputs()
    want = jm.apply(params, x, li, x, 1 - li, mode="sched", deterministic=True)
    got = pm(_t(x), _t(li), _t(x), _t(1 - li))
    assert got.dtype == torch.float32
    _close(got, want, "teacher-forced logits")


def test_soft_input_logits_match_jax(narrow):
    """A soft (B, L, V) encoder input goes through hard_sample_st(inp) @
    table on both sides."""
    jm, params, pm = narrow
    x, li = _inputs()
    soft = np.random.default_rng(1).random((B, L, V)).astype(np.float32)
    want = jm.apply(params, soft, li, x, 1 - li, mode="sched", deterministic=True)
    _close(pm(_t(soft), _t(li), _t(x), _t(1 - li)), want, "soft-input logits")


def test_greedy_ids_match_jax(narrow):
    jm, params, pm = narrow
    x, li = _inputs(2)
    want = np.asarray(jax_tf.generate(jm, params, x, li, 1 - li, mode="greedy"))
    got = generate(pm, _t(x), _t(li), _t(1 - li), mode="greedy")
    assert got.dtype == torch.int32 and got.shape == (B, L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_st_probs_and_their_gradient_match_jax(narrow):
    """``st`` probs at tau 0.5, and the gradient of sum(probs * w) for a
    fixed random w with respect to a few parameters across the model (the
    straight-through feedback carries it through every step)."""
    jm, params, pm = narrow
    x, li = _inputs(3)
    w = np.random.default_rng(4).standard_normal((B, L, V)).astype(np.float32)

    def loss(p):
        return jnp.sum(jax_tf.generate(jm, p, x, li, 1 - li, mode="st", tau=0.5) * w)

    want_probs = jax_tf.generate(jm, params, x, li, 1 - li, mode="st", tau=0.5)
    want_grads = transformer_generator_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.grad(loss)(params)))
    probs = generate(pm, _t(x), _t(li), _t(1 - li), mode="st", tau=0.5)
    _close(probs, want_probs, "st probs")
    pm.zero_grad()
    (probs * _t(w)).sum().backward()
    named = dict(pm.named_parameters())
    for key in ("token_embedding.weight", "posit_embedding.weight", "style_embedding.weight",
                "start_embedding.weight", "lm_head.weight", "enc_0.attn.q.weight",
                "enc_1.ffn.wi.bias", "dec_0.self_attn.k.weight", "dec_1.cross_attn.v.weight",
                "dec_1.ln3.weight", "dec_norm.bias"):
        assert float(want_grads[key].abs().max()) > 0, key
        _close(named[key].grad, want_grads[key].numpy(), f"grad {key}")
    pm.zero_grad()


def test_sched_without_teacher_matches_jax(narrow):
    """``sched`` with x=None: greedy feedback, logits out."""
    jm, params, pm = narrow
    x, li = _inputs(5)
    want = jax_tf.generate(jm, params, x, li, 1 - li, mode="sched")
    _close(generate(pm, _t(x), _t(li), _t(1 - li), mode="sched"), want, "sched logits")


def test_cached_decode_equals_the_parallel_pass(narrow):
    """Greedy ids fed back as the teacher reproduce their own argmax at every
    step: the KV-cached step equals the causal parallel pass."""
    _, _, pm = narrow
    x, li = (_t(a) for a in _inputs(6))
    ids = generate(pm, x, li, 1 - li, mode="greedy")
    np.testing.assert_array_equal(pm(x, li, ids, 1 - li).argmax(-1).numpy(), ids.numpy())


def test_computes_in_float32_under_bf16_autocast(narrow):
    """As the JAX module does whatever its dtype: autocast is off inside the
    forward and generate, so the logits are float32 and the same."""
    _, _, pm = narrow
    x, li = (_t(a) for a in _inputs(7))
    want = pm(x, li, x, 1 - li)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = pm(x, li, x, 1 - li)
        sched = generate(pm, x, li, 1 - li, mode="sched")
    assert got.dtype == sched.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(sched, generate(pm, x, li, 1 - li, mode="sched"))


def test_generate_rejects_teacher_and_gumbel(narrow):
    _, _, pm = narrow
    x, li = (_t(a) for a in _inputs())
    for mode in ("teacher", "gumbel"):
        with pytest.raises(ValueError, match="mode must be one of"):
            generate(pm, x, li, 1 - li, mode=mode)


def test_dropout_draws_from_the_given_generator():
    """Train mode: dropout on the embedded inputs, its masks from the
    generator (the same seed gives the same probs, another seed others);
    eval mode draws nothing."""
    pm = TransformerSeq2Seq(V, 2, L, p_drop=0.3, seed=1, **PORT_NARROW).train()
    x, li = (_t(a) for a in _inputs())

    def st(seed):
        return generate(pm, x, li, 1 - li, mode="st",
                        generator=torch.Generator().manual_seed(seed)).detach()

    assert torch.equal(st(0), st(0)) and not torch.equal(st(0), st(1))
    pm.eval()
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    generate(pm, x, li, 1 - li, mode="st", generator=g)
    assert torch.equal(g.get_state(), before)


def test_fresh_weights_follow_the_jax_distributions():
    """Seeded: the same seed gives the same weights. Tokens and start N(0,
    1); positions and style xavier uniform; Dense U(+-1/sqrt(fan_in)); the
    head has no bias; LayerNorm ones and zeros."""
    a = TransformerSeq2Seq(500, 2, L, seed=3, **PORT_NARROW).requires_grad_(False)
    b = TransformerSeq2Seq(500, 2, L, seed=3, **PORT_NARROW)
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                b.state_dict().values()))
    d = 32
    assert abs(float(a.token_embedding.weight.std()) - 1.0) < 0.05
    assert float(a.posit_embedding.weight.abs().max()) <= (6.0 / (tf.MAX_POS + d)) ** 0.5
    assert float(a.style_embedding.weight.abs().max()) <= (6.0 / (2 + d)) ** 0.5
    assert float(a.dec_0.ffn.wo.weight.abs().max()) <= 64 ** -0.5
    assert float(a.dec_0.ffn.wo.bias.abs().max()) <= 64 ** -0.5
    assert float(a.enc_1.attn.q.bias.abs().max()) > 0
    assert a.lm_head.bias is None
    assert torch.equal(a.enc_norm.weight, torch.ones(d)) and not a.dec_1.ln2.bias.any()


def test_full_width_greedy_ids_match_jax(monkeypatch):
    """T5-small widths (d=512, 8 heads, 6+6 layers, ff 2048) with V=50,
    B=3, L=6, as the JAX package's own test runs them: greedy ids equal, and
    the teacher-forced logits within the stated bound."""
    for k, v in FULL.items():  # the JAX module's own widths for this test
        monkeypatch.setattr(jax_tf, k, v)
    Vf = 50
    jm = jax_tf.TransformerSeq2Seq(n_vocab=Vf, n_class=2, max_len=L, p_drop=0.0)
    rng = np.random.default_rng(8)
    x = rng.integers(3, Vf, (B, L)).astype(np.int32)
    li = np.array([1, 0, 1], np.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x, li, None, li,
                                              deterministic=True))
    pm = TransformerSeq2Seq(Vf, 2, L, p_drop=0.0).eval()
    assert (pm.enc_5.ffn.wi.out_features, len(pm.dec_layers), pm.dec_0.self_attn.n_heads) \
        == (2048, 6, 8)
    pm.load_state_dict(transformer_generator_state_dict_from_jax(params), strict=True)
    want = np.asarray(jax_tf.generate(jm, params, x, li, 1 - li, mode="greedy"))
    np.testing.assert_array_equal(generate(pm, _t(x), _t(li), _t(1 - li)).numpy(), want)
    logits = jm.apply(params, x, li, want, 1 - li, mode="sched", deterministic=True)
    with torch.no_grad():
        _close(pm(_t(x), _t(li), _t(want), _t(1 - li)), logits, "full-width logits")
