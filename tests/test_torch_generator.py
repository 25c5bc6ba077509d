"""The port's generator against the JAX package's ``DenoiseSeq2Seq`` on the
same weights: JAX params go through ``generator_state_dict_from_jax`` into
the port, both decode the same numpy inputs on the CPU. Parity is held in
float32; bfloat16 rounds at other places in the two frameworks, so it gets a
looser check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.utils import torch_interop as ti  # noqa: E402
from consistent__style_transfer_torch.models.generator import (  # noqa: E402
    DenoiseSeq2Seq,
    greedy_transfer,
)
from consistent__style_transfer_torch.utils.interop import (  # noqa: E402
    generator_state_dict_from_jax,
)

V, B, L = 60, 4, 7
# f32 logits here are below 0.1 in magnitude and the two frameworks sum the
# matmuls in different orders (about 1e-7 apart seen)
LOGIT_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((2, L), jnp.int32)
    lab = jnp.zeros((2,), jnp.int32)
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L)
    params = model.init(jax.random.PRNGKey(0), x, lab, None, lab, deterministic=True)
    return jax.tree.map(np.asarray, jax.device_get(params))


def _batch(seed=0, padded=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(3, V, (B, L)).astype(np.int32)
    if padded:  # right-padded rows of different lengths, one of them empty
        for i, n in enumerate((L, 4, 1, 0)):
            x[i, n:] = 0
    labels = np.array([0, 1, 1, 0], np.int32)
    return x, labels


def _port(jax_params, dtype=torch.float32, rep_penalty=0.0):
    model = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L, rep_penalty=rep_penalty)
    model.load_state_dict(generator_state_dict_from_jax(jax_params), strict=True)
    return model.to(dtype).eval()


def _jax_decode(jax_params, x, labels, mode, dtype=jnp.float32, rep_penalty=0.0):
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L, dtype=dtype, rep_penalty=rep_penalty)
    out = model.apply(jax_params, jnp.asarray(x), jnp.asarray(labels), None,
                      jnp.asarray(1 - labels), mode=mode, deterministic=True)
    return np.asarray(out.astype(jnp.float32) if mode == "sched" else out)


def test_state_dict_matches_torch_interop_and_loads_strict(jax_params, tmp_path):
    ours = generator_state_dict_from_jax(jax_params)
    ref = ti.generator_to_state_dict(jax_params)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)  # exact copy
    model = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L)
    assert sorted(model.state_dict()) == sorted(ref)
    model.load_state_dict(ours, strict=True)
    path = str(tmp_path / "G.pth")
    ti.save_pth(jax_params, "generator", path)  # the JAX package's own .pth writer
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_greedy_ids_match_jax_f32(jax_params, padded):
    """ids exact. The padded case holds the full-length flip of the backward
    encoder and the unmasked attention over PAD positions against JAX."""
    x, labels = _batch(1, padded)
    want = _jax_decode(jax_params, x, labels, "greedy")
    got = greedy_transfer(_port(jax_params), torch.from_numpy(x), torch.from_numpy(labels))
    assert got.dtype == torch.int32 and got.shape == (B, L)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_sched_logits_match_jax_f32(jax_params, padded):
    x, labels = _batch(2, padded)
    want = _jax_decode(jax_params, x, labels, "sched")
    with torch.no_grad():
        got = _port(jax_params)(torch.from_numpy(x), torch.from_numpy(labels), None,
                                torch.from_numpy(1 - labels), mode="sched")
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_padding_is_not_length_aware(jax_params):
    """A PAD-only tail changes the transfer: the backward encoder starts on the
    PADs and attention reads them, as in the JAX package (a packed-sequence
    encoder or a masked attention would ignore them)."""
    x, labels = _batch(3)
    x[:, 4:] = 0
    short = x[:, :4]
    model = _port(jax_params)
    with torch.no_grad():
        full = model(torch.from_numpy(x), torch.from_numpy(labels), None,
                     torch.from_numpy(1 - labels), mode="sched")
        cut = model(torch.from_numpy(short), torch.from_numpy(labels), None,
                    torch.from_numpy(1 - labels), mode="sched")
    assert (full - cut).abs().max() > 1e-3
    want = _jax_decode(jax_params, x, labels, "sched")
    np.testing.assert_allclose(full.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_rep_penalty_ids_match_jax_f32(jax_params):
    x, labels = _batch(4)
    want = _jax_decode(jax_params, x, labels, "greedy", rep_penalty=0.5)
    got = greedy_transfer(_port(jax_params, rep_penalty=0.5), torch.from_numpy(x),
                          torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = greedy_transfer(_port(jax_params), torch.from_numpy(x), torch.from_numpy(labels))
    assert not torch.equal(got, plain)  # the penalty did act


def test_bf16_first_step_close_to_jax_bf16(jax_params):
    """bf16 (8 significant bits) rounds at other places in the two frameworks,
    so only the first decode step, before any argmax feeds back, is compared:
    logits within 2e-3, four bf16 ulps at their magnitude here (|logit| < 0.125,
    ulp 2^-11; one ulp seen)."""
    x, labels = _batch(5)
    want = _jax_decode(jax_params, x, labels, "sched", dtype=jnp.bfloat16)
    with torch.no_grad():
        got = _port(jax_params, torch.bfloat16)(
            torch.from_numpy(x), torch.from_numpy(labels), None,
            torch.from_numpy(1 - labels), mode="sched").float()
    assert np.abs(want[:, 0]).max() < 0.125
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0], atol=2e-3, rtol=0)
