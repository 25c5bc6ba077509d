"""The port's decode head (``kernels/decode_step.py``) against the JAX
package's Pallas kernel in interpret mode and its jnp reference, on the
shapes of ``tests/test_kernels.py``. On the CPU the port's wrapper runs its
plain version; the CUDA kernel itself is held against that plain version in
``test_torch_decode_head_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.kernels.decode_step import (  # noqa: E402
    decode_head_reference as jax_reference,
)
from consistent__style_transfer_tpu.kernels.decode_step import (  # noqa: E402
    fused_decode_logits as jax_fused,
)
from consistent__style_transfer_torch.kernels.decode_step import (  # noqa: E402
    decode_head_reference,
    fused_decode_logits,
)

H_ATOL = 1e-5  # f32 h: the same sums in another order


def _inputs(seed, B, Din, H, V, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Din)).astype(np.float32)
    w1 = (rng.normal(size=(Din, H)) * scale).astype(np.float32)  # JAX layout (in, out)
    b1 = (rng.normal(size=(H,)) * scale).astype(np.float32)
    w2 = (rng.normal(size=(H, V)) * scale).astype(np.float32)
    return x, w1, b1, w2


def _port_head(fn, x, w1, b1, w2, device="cpu", dtype=torch.float32):
    """Calls the port's head with the port's nn.Linear layout."""
    t = [torch.tensor(a, dtype=dtype, device=device) for a in (x, w1.T, b1, w2.T)]
    ids, h = fn(*t)
    return ids.cpu().numpy(), h.float().cpu().numpy()


@pytest.mark.parametrize("shape,tile_v", [((8, 64, 32, 300), 128), ((4, 16, 8, 64), 64)],
                         ids=["ragged_tiles", "single_tile"])
def test_plain_head_matches_jax_kernel_and_reference(shape, tile_v):
    x, w1, b1, w2 = _inputs(1, *shape)
    ref_ids, ref_h = (np.asarray(a) for a in jax_reference(x, w1, b1, w2))
    k_ids, k_h = (np.asarray(a) for a in jax_fused(x, w1, b1, w2, tile_v=tile_v, interpret=True))
    for fn in (decode_head_reference, fused_decode_logits):
        ids, h = _port_head(fn, x, w1, b1, w2)
        assert ids.dtype == np.int32 and ids.shape == (shape[0],)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(ids, k_ids)
        np.testing.assert_allclose(h, ref_h, rtol=0, atol=H_ATOL)
        np.testing.assert_allclose(h, k_h, rtol=0, atol=H_ATOL)


def _tie_inputs():
    """Every row's maximum logit sits on two columns, 5 and 200, which fall in
    different 128-column tiles of the JAX kernel: the first index must win.
    h > 0 (large bias), the other columns of W2 are negative and columns 5 and
    200 zero, so the tie is exact whatever order the sums take."""
    x, w1, b1, w2 = _inputs(3, 8, 64, 32, 300)
    b1 = np.full_like(b1, 10.0)
    w2 = -np.abs(w2) - 0.01
    w2[:, 5] = w2[:, 200] = 0.0
    return x, w1, b1, w2


def test_tie_goes_to_first_index():
    x, w1, b1, w2 = _tie_inputs()
    ref_ids = np.asarray(jax_reference(x, w1, b1, w2)[0])
    k_ids = np.asarray(jax_fused(x, w1, b1, w2, tile_v=128, interpret=True)[0])
    ids, _ = _port_head(fused_decode_logits, x, w1, b1, w2)
    for got in (ref_ids, k_ids, ids):
        np.testing.assert_array_equal(got, 5)


def test_cpu_wrapper_does_not_count_launches():
    x, w1, b1, w2 = _inputs(4, 4, 16, 16, 64)
    before = fused_decode_logits.launches
    _port_head(fused_decode_logits, x, w1, b1, w2)
    assert fused_decode_logits.launches == before
