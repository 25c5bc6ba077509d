"""The Sinkhorn CUDA kernel (``csrc/sinkhorn.cu``) against its plain PyTorch
version (``ops/emd.py::sinkhorn_ot_cost``) on the card, through both names.
Every test needs a CUDA device and skips without one. This file imports no
JAX, so it runs on a machine that has only PyTorch (tests/conftest.py
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sinkhorn_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.kernels.sinkhorn import (  # noqa: E402
    MAX_ATOMS,
    sinkhorn_cuda,
    sinkhorn_pallas,
    sinkhorn_pallas_cr,
)
from consistent__style_transfer_torch.ops.emd import sinkhorn_ot_cost  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(seed, B, N, M, n_on=None, m_on=None, dim=100):
    """Histograms with zero tails (N - n_on, M - m_on padded atoms) and the
    euclidean cost between unit vectors of ``dim``, as the WMD labeler
    builds it."""
    rng = np.random.default_rng(seed)
    p = rng.random((B, N)).astype(np.float32) + 0.05
    q = rng.random((B, M)).astype(np.float32) + 0.05
    p[:, N if n_on is None else n_on:] = 0
    q[:, M if m_on is None else m_on:] = 0
    p /= np.maximum(p.sum(-1, keepdims=True), 1e-9)
    q /= np.maximum(q.sum(-1, keepdims=True), 1e-9)
    x = rng.normal(size=(B, N, dim))
    y = rng.normal(size=(B, M, dim))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    diff = x[:, :, None, :] - y[:, None, :, :]
    D = np.sqrt(np.maximum((diff * diff).sum(-1), 1e-12)).astype(np.float32)
    return p, q, D


@pytest.mark.parametrize("entry", [sinkhorn_pallas, sinkhorn_pallas_cr],
                         ids=["sinkhorn_pallas", "sinkhorn_pallas_cr"])
@pytest.mark.parametrize("shape", [(256, 27, 27, 20, 15), (128, 45, 45, 40, 33),
                                   (5, 9, 7, 7, 5), (1, 27, 27, 9, 12), (3, 64, 64, 64, 50)],
                         ids=["yelp", "book", "ragged", "single", "cap"])
def test_kernel_matches_plain(cuda_device, entry, shape):
    """rtol 1e-4, atol 1e-5 (tests/test_kernels.py:35): the same f32 terms,
    summed in another order."""
    p, q, D = (torch.tensor(a, device=cuda_device) for a in _inputs(1, *shape))
    before = sinkhorn_cuda.launches
    got = entry(p, q, D)
    assert sinkhorn_cuda.launches == before + 1
    ref = sinkhorn_ot_cost(p, q, D)
    torch.cuda.synchronize()
    assert got.shape == (shape[0],) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_all_zero_pairs_give_zero(cuda_device):
    """A fallback row of the labeler (both histograms zeroed), a pair with one
    empty side, and a normal pair beside them."""
    p, q, D = _inputs(2, 4, 27, 27, 10, 8)
    p[0], q[0] = 0, 0
    p[1] = 0
    q[2] = 0
    t = [torch.tensor(a, device=cuda_device) for a in (p, q, D)]
    got = sinkhorn_pallas(*t).cpu().numpy()
    ref = sinkhorn_ot_cost(*t).cpu().numpy()
    np.testing.assert_array_equal(got[:3], 0.0)
    assert np.isfinite(got).all() and got[3] > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    p, q, D = (torch.tensor(a, device=cuda_device) for a in _inputs(3, 2, 8, 8))
    with pytest.raises(TypeError):
        sinkhorn_pallas(p.double(), q.double(), D.double())
    with pytest.raises(ValueError):
        sinkhorn_pallas(p, q, D.transpose(1, 2))  # not contiguous
    big = MAX_ATOMS + 1
    pb, qb, Db = (torch.tensor(a, device=cuda_device) for a in _inputs(3, 2, big, 8))
    with pytest.raises(ValueError):
        sinkhorn_pallas(pb, qb, Db)
