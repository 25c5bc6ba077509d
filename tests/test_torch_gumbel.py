"""The generator's ``gumbel`` mode against the JAX package's, on the CPU in
float32, on the same weights and the same noise: the probs, their argmax
ids, and the gradient of a scalar of the probs to every parameter (the
table's gradient included: the straight-through feedback reaches it).

The JAX module draws its noise inside the decode scan with
``jax.random.gumbel``; the test replaces that function while the JAX
forward runs by one that draws the same and records what it drew, step by
step, and hands the recorded (L, B, V) noise to the port (its ``noise``
argument). A second JAX call with the same key draws the same noise again,
for the gradient. Dropout is off on both sides (``deterministic=True``; the
port in eval mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_torch.models.generator import (  # noqa: E402
    DenoiseSeq2Seq,
    gumbel_noise,
)
from consistent__style_transfer_torch.utils.interop import generator_state_dict_from_jax  # noqa: E402

V, B, L = 50, 4, 6
TAU = 0.5
# f32 probs: the two frameworks sum the products in other orders (about 1e-7
# apart); 1e-5 leaves two orders of magnitude. Gradients: each within 1e-4
# of the largest entry of its parameter's gradient
ATOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    x = jnp.zeros((2, L), jnp.int32)
    lab = jnp.zeros((2,), jnp.int32)
    params = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L).init(
        jax.random.PRNGKey(0), x, lab, x, lab, deterministic=True)
    params = jax.tree.map(np.asarray, jax.device_get(params))
    rng = np.random.default_rng(3)
    inp = rng.integers(3, V, (B, L)).astype(np.int32)
    labels = np.array([0, 1, 1, 0], np.int32)
    w = rng.normal(size=(B, L, V)).astype(np.float32)
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
    key = jax.random.PRNGKey(11)

    def probs_of(p):
        return model.apply(p, jnp.asarray(inp), jnp.asarray(labels), None,
                           jnp.asarray(1 - labels), mode="gumbel", tau=TAU, deterministic=True,
                           rngs={"gumbel": key})

    drawn, real = [], jax.random.gumbel

    def recording(k, shape=(), dtype=jnp.float32):
        g = real(k, shape, dtype)
        jax.debug.callback(lambda v: drawn.append(np.asarray(v)), g, ordered=True)
        return g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", recording)
        probs = np.asarray(probs_of(params))
    grads = jax.grad(lambda p: jnp.sum(probs_of(p) * w))(params)
    return {"params": params, "inp": inp, "labels": labels, "w": w, "probs": probs,
            "noise": np.stack(drawn), "grads": generator_state_dict_from_jax(
                jax.tree.map(np.asarray, grads))}


def _port(case):
    model = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.1).eval()
    model.load_state_dict(generator_state_dict_from_jax(case["params"]), strict=True)
    return model


def _decode(model, case, **kw):
    return model(torch.from_numpy(case["inp"]), torch.from_numpy(case["labels"]), None,
                 torch.from_numpy(1 - case["labels"]), mode="gumbel", tau=TAU,
                 noise=torch.from_numpy(case["noise"]), **kw)


def test_gumbel_probs_and_ids_match_jax(case):
    assert case["noise"].shape == (L, B, V)
    with torch.no_grad():
        got = _decode(_port(case), case).numpy()
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got, case["probs"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), case["probs"].argmax(-1))
    # the noise matters: st mode (no noise) gives other probs
    with torch.no_grad():
        st = _port(case)(torch.from_numpy(case["inp"]), torch.from_numpy(case["labels"]), None,
                         torch.from_numpy(1 - case["labels"]), mode="st", tau=TAU).numpy()
    assert np.abs(st - got).max() > 1e-2


def test_gumbel_gradient_matches_jax(case):
    model = _port(case)
    probs = _decode(model, case)
    (probs * torch.from_numpy(case["w"])).sum().backward()
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(case["grads"])
    for k, g in case["grads"].items():
        scale = float(g.abs().max())
        err = float((named[k].grad - g).abs().max())
        assert err <= GRAD_REL * scale + 1e-9, f"{k}: max abs err {err} vs {GRAD_REL} x {scale}"
    assert named["token_embedding.weight"].grad.abs().max() > 0


def test_gumbel_noise_draws_like_jax():
    """The port's own draw: finite, from the explicit generator (the same
    seed gives the same noise), with the standard Gumbel's mean (Euler's
    constant, 0.5772) and variance (pi^2 / 6)."""
    g = gumbel_noise((200, 500), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(g).all() and g.dtype == torch.float32
    assert torch.equal(g, gumbel_noise((200, 500), torch.Generator().manual_seed(0), "cpu"))
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03
    with torch.no_grad():  # drawn inside the decode when not given
        model = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L).eval()
        x, lab = torch.zeros(2, L, dtype=torch.long), torch.zeros(2, dtype=torch.long)
        a = model(x, lab, None, lab, mode="gumbel", generator=torch.Generator().manual_seed(1))
        b = model(x, lab, None, lab, mode="gumbel", generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_drawn_noise_is_one_draw_a_step_from_the_generator(case):
    """Without ``noise`` the decode draws a (B, V) Gumbel sample a step from
    ``generator``, in step order: the same probs as the (L, B, V) noise made
    by L calls of ``gumbel_noise`` on a generator from the same seed."""
    model = _port(case)
    drawn = torch.Generator().manual_seed(5)
    noise = torch.stack([gumbel_noise((B, V), drawn, "cpu") for _ in range(L)])
    with torch.no_grad():
        args = (torch.from_numpy(case["inp"]), torch.from_numpy(case["labels"]), None,
                torch.from_numpy(1 - case["labels"]))
        got = model(*args, mode="gumbel", tau=TAU, generator=torch.Generator().manual_seed(5))
        want = model(*args, mode="gumbel", tau=TAU, noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
