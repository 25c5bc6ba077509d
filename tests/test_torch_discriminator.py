"""The RelGAN discriminator against the JAX package's on the same weights, on
the CPU in float32: id, soft and time-major inputs; the state-dict mapping;
the RelGAN init's scale per parameter; dropout (seeded, off in eval). The
JAX side runs with ``deterministic=True`` (no dropout), the port in eval
mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.models.discriminator import (  # noqa: E402
    RelGANDiscriminator as JaxDisc,
)
from consistent__style_transfer_tpu.utils import torch_interop as ti  # noqa: E402
from consistent__style_transfer_torch.models import RelGANDiscriminator  # noqa: E402
from consistent__style_transfer_torch.utils.interop import (  # noqa: E402
    discriminator_state_dict_from_jax,
)

V, B, L = 40, 3, 8
# f32 logits of order 1 summed in other orders on the two sides
ATOL = 1e-5


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
    params = JaxDisc(n_vocab=V).init(jax.random.PRNGKey(0), jnp.zeros((2, L), jnp.int32))
    return jax.tree.map(np.asarray, jax.device_get(params))


def _port(jax_params, p_drop=0.25):
    model = RelGANDiscriminator(V, p_drop=p_drop)
    model.load_state_dict(discriminator_state_dict_from_jax(jax_params), strict=True)
    return model.eval()


def _jax(jax_params, inp, time_major=False):
    return np.asarray(JaxDisc(n_vocab=V).apply(jax_params, jnp.asarray(inp), deterministic=True,
                                               time_major=time_major))


def test_state_dict_matches_torch_interop_and_loads_strict(jax_params, tmp_path):
    ours = discriminator_state_dict_from_jax(jax_params)
    ref = ti.discriminator_to_state_dict(jax_params)
    assert sorted(ours) == sorted(ref) == sorted(RelGANDiscriminator(V).state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours["embeddings.weight"].shape == (128, V)
    assert ours["convs.0.weight"].shape == (300, 1, 2, 8)
    path = str(tmp_path / "D.pth")
    ti.save_pth(jax_params, "discriminator", path)
    RelGANDiscriminator(V).load_state_dict(torch.load(path, weights_only=True), strict=True)


def test_ids_match_jax(jax_params):
    x = np.random.default_rng(1).integers(0, V, (B, L)).astype(np.int32)
    want = _jax(jax_params, x)
    with torch.no_grad():
        got = _port(jax_params)(torch.from_numpy(x)).numpy()
    assert got.shape == (B * 16,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_soft_and_time_major_match_jax(jax_params):
    soft = np.random.default_rng(2).dirichlet(np.ones(V), (B, L)).astype(np.float32)
    want = _jax(jax_params, soft)
    model = _port(jax_params)
    with torch.no_grad():
        got = model(torch.from_numpy(soft)).numpy()
        tm = model(torch.from_numpy(soft.transpose(1, 0, 2).copy()), time_major=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm, _jax(jax_params, soft.transpose(1, 0, 2), time_major=True),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm, got, atol=1e-6, rtol=0)
    # a one-hot distribution is the id input
    ids = soft.argmax(-1)
    with torch.no_grad():
        hot = model(torch.nn.functional.one_hot(torch.from_numpy(ids), V).float()).numpy()
        gathered = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(hot, gathered, atol=1e-6, rtol=0)


def test_relgan_init_scale_per_parameter(jax_params):
    """N(0, 1/sqrt(shape[0])) in torch layout is the JAX package's
    N(0, 1/sqrt(shape[-1])) in flax layout, parameter by parameter; the
    port's and JAX's fresh draws have that scale (within 20%, about three
    standard errors for the 100 or more entries checked)."""
    port = RelGANDiscriminator(V, seed=3).state_dict()
    fresh = discriminator_state_dict_from_jax(jax.tree.map(
        np.asarray, JaxDisc(n_vocab=V).init(jax.random.PRNGKey(4), jnp.zeros((2, L), jnp.int32))))
    flax_shapes = {}
    p = jax_params["params"]
    flax_shapes["embeddings.weight"] = p["embeddings"].shape
    for name in ("highway", "feature2out", "out2logits"):
        flax_shapes[f"{name}.weight"] = p[name]["kernel"].shape
        flax_shapes[f"{name}.bias"] = p[name]["bias"].shape
    for i, f in enumerate((2, 3, 4, 5)):
        flax_shapes[f"convs.{i}.weight"] = p[f"conv_{f}"]["kernel"].shape
        flax_shapes[f"convs.{i}.bias"] = p[f"conv_{f}"]["bias"].shape
    assert sorted(flax_shapes) == sorted(port)
    for k, t in port.items():
        fs = flax_shapes[k]
        want = 1.0 / np.sqrt(fs[-1] if len(fs) > 1 else fs[0])
        assert want == pytest.approx(1.0 / np.sqrt(t.shape[0]), rel=1e-12), k
        if t.numel() >= 100:
            for name, sample in (("port", t), ("jax", fresh[k])):
                std = float(sample.float().std())
                assert std == pytest.approx(want, rel=0.2), f"{name} {k}: std {std} vs {want}"
                assert abs(float(sample.mean())) < 4 * want / np.sqrt(t.numel()) + 1e-6, k


def test_dropout_seeded_in_train_and_off_in_eval(jax_params):
    x = torch.from_numpy(np.random.default_rng(5).integers(0, V, (B, L)).astype(np.int32))
    model = _port(jax_params)
    with torch.no_grad():
        model.train()
        a = model(x, torch.Generator().manual_seed(0))
        b = model(x, torch.Generator().manual_seed(0))
        c = model(x, torch.Generator().manual_seed(1))
        model.eval()
        e = model(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_allclose(e.numpy(), _jax(jax_params, x.numpy()), atol=ATOL, rtol=0)
