"""The decode-head CUDA kernel (``csrc/decode_step.cu``) against its plain
PyTorch version on the card: float32 on the CUDA cores, bfloat16 on the
tensor cores (wgmma on TMA-fed tiles). Every test needs a CUDA device and
skips without one. This file imports no JAX, so it runs on a machine that
has only PyTorch (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_head_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.kernels.decode_step import (  # noqa: E402
    decode_head_reference,
    fused_decode_logits,
)
from consistent__style_transfer_torch.utils.profiling import total  # noqa: E402

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
    before = total("kernel.fused_decode_logits")
    ids, h = _run(fused_decode_logits, arrays, cuda_device)
    assert total("kernel.fused_decode_logits") == before + 1
    ref_ids, ref_h = _run(decode_head_reference, arrays, cuda_device)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(h, ref_h, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_kernel_tie_goes_to_first_index(cuda_device, dtype):
    """Columns 5 and 200 hold every row's maximum exactly (h > 0, the other
    columns negative, these two zero, also after rounding to bf16): the
    smaller index wins."""
    x, w1, b1, w2 = _inputs(3, 8, 64, 32, 300)
    b1 = np.full_like(b1, 10.0)
    w2 = -np.abs(w2) - 0.01
    w2[5] = w2[200] = 0.0
    ids, _ = _run(fused_decode_logits, (x, w1, b1, w2), cuda_device, dtype)
    np.testing.assert_array_equal(ids, 5)


def _head_inputs(seed, B, V, Din=1024, H=512):
    """The serving shapes with the generator's init distributions: x in
    (-1, 1), weights and bias uniform in +-fan_in ** -0.5."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, Din)).astype(np.float32),
            rng.uniform(-1, 1, (H, Din)).astype(np.float32) * Din ** -0.5,
            rng.uniform(-1, 1, (H,)).astype(np.float32) * Din ** -0.5,
            rng.uniform(-1, 1, (V, H)).astype(np.float32) * H ** -0.5)


def _check_bf16(arrays, device):
    """bf16 (chip_smoke.py's checks): h within 2e-2 of the plain bf16 h
    relative to its size and within 1e-4 of f32 math on the same rounded
    inputs; an id that differs from the plain version's must be a near-tie
    (within 1e-2) of the f32 logits' maximum. One launch per call."""
    x, w1, b1, w2 = (torch.tensor(a, device=device).to(torch.bfloat16) for a in arrays)
    before = total("kernel.fused_decode_logits")
    ids, h = fused_decode_logits(x, w1, b1, w2)
    assert total("kernel.fused_decode_logits") == before + 1
    ref_ids, ref_h = decode_head_reference(x, w1, b1, w2)
    h32 = decode_head_reference(x.float(), w1.float(), b1.float(), w2.float())[1]
    logits32 = h32 @ w2.float().t()
    assert ids.dtype == torch.int32 and ids.shape == (x.shape[0],) and h.dtype == torch.float32
    assert bool(((ids >= 0) & (ids < w2.shape[0])).all())
    scale = ref_h.float().abs().max().item()
    assert (h - ref_h.float()).abs().max().item() <= 2e-2 * scale
    assert (h - h32).abs().max().item() <= 1e-4
    rows = (ids != ref_ids).nonzero().flatten()
    if rows.numel():
        gap = (logits32[rows].max(-1).values - logits32[rows, ids[rows].long()]).max().item()
        assert gap <= 1e-2, f"rows {rows.tolist()[:8]} off the f32 maximum by {gap}"
    return ids, logits32


@pytest.mark.parametrize("B,V", [(1, 10000), (200, 10000), (256, 10000), (256, 5317)],
                         ids=["B1", "B200", "yelp", "yelp_bpe_vocab"])
def test_kernel_matches_plain_bf16(cuda_device, B, V):
    _check_bf16(_head_inputs(7, B, V), cuda_device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64, 32, 300), (256, 1024, 512, 5317)],
                         ids=["ragged", "yelp_bpe_vocab"])
def test_padded_columns_never_win(cuda_device, dtype, shape):
    """Every valid logit is negative (h > 0, W2 < 0) and V is no multiple of
    any tile width, so a zero-filled column past V would win if it were not
    masked."""
    B, Din, H, V = shape
    x, w1, b1, w2 = _inputs(8, B, Din, H, V)
    b1 = np.full_like(b1, 10.0)
    w2 = -np.abs(w2) - 0.01
    if dtype == "bfloat16":
        ids, logits32 = _check_bf16((x, w1, b1, w2), cuda_device)
        assert bool((logits32 < 0).all())
    else:
        ids, _ = _run(fused_decode_logits, (x, w1, b1, w2), cuda_device)
        ref_ids, _ = _run(decode_head_reference, (x, w1, b1, w2), cuda_device)
        np.testing.assert_array_equal(ids, ref_ids)
    assert int(ids.max()) < V


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x, w1, b1, w2 = (torch.tensor(a, device=cuda_device) for a in _inputs(6, 4, 16, 16, 64))
    with pytest.raises(TypeError):
        fused_decode_logits(x.double(), w1.double(), b1.double(), w2.double())
    with pytest.raises(ValueError):
        fused_decode_logits(x, w1.T.contiguous().T, b1, w2)  # not contiguous
    with pytest.raises(ValueError):
        fused_decode_logits(x[:, :10].contiguous(), w1[:, :10].contiguous(), b1, w2)  # Din % 16
