"""The decode-head CUDA kernel (``csrc/decode_step.cu``) against its plain
PyTorch version on the card. Every test needs a CUDA device and skips
without one. This file imports no JAX, so it runs on a machine that has only
PyTorch (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_head_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.kernels.decode_step import (  # noqa: E402
    decode_head_reference,
    fused_decode_logits,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(seed, B, Din, H, V, scale=0.1):
    """x (B, Din), w1 (H, Din), b1 (H,), w2 (V, H): the nn.Linear layout."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Din)).astype(np.float32),
            (rng.normal(size=(H, Din)) * scale).astype(np.float32),
            (rng.normal(size=(H,)) * scale).astype(np.float32),
            (rng.normal(size=(V, H)) * scale).astype(np.float32))


def _run(fn, arrays, device, dtype=torch.float32):
    ids, h = fn(*(torch.tensor(a, dtype=dtype, device=device) for a in arrays))
    return ids.cpu().numpy(), h.float().cpu().numpy()


@pytest.mark.parametrize("shape", [(8, 64, 32, 300), (4, 16, 16, 64), (200, 1024, 512, 5317)],
                         ids=["ragged", "single_tile", "serve_width"])
def test_kernel_matches_plain_f32(cuda_device, shape):
    """f32 without TF32: ids equal, h within 1e-4 (the same f32 sums in
    another order)."""
    arrays = _inputs(5, *shape)
    before = fused_decode_logits.launches
    ids, h = _run(fused_decode_logits, arrays, cuda_device)
    assert fused_decode_logits.launches == before + 1
    ref_ids, ref_h = _run(decode_head_reference, arrays, cuda_device)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(h, ref_h, rtol=0, atol=1e-4)


def test_kernel_tie_goes_to_first_index(cuda_device):
    """Columns 5 and 200 hold every row's maximum exactly (h > 0, the other
    columns negative, these two zero): the smaller index wins."""
    x, w1, b1, w2 = _inputs(3, 8, 64, 32, 300)
    b1 = np.full_like(b1, 10.0)
    w2 = -np.abs(w2) - 0.01
    w2[5] = w2[200] = 0.0
    ids, _ = _run(fused_decode_logits, (x, w1, b1, w2), cuda_device)
    np.testing.assert_array_equal(ids, 5)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x, w1, b1, w2 = (torch.tensor(a, device=cuda_device) for a in _inputs(6, 4, 16, 16, 64))
    with pytest.raises(TypeError):
        fused_decode_logits(x.double(), w1.double(), b1.double(), w2.double())
    with pytest.raises(ValueError):
        fused_decode_logits(x, w1.T.contiguous().T, b1, w2)  # not contiguous
    with pytest.raises(ValueError):
        fused_decode_logits(x[:, :10].contiguous(), w1[:, :10].contiguous(), b1, w2)  # Din % 16
