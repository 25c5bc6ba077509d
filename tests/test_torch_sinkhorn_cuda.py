"""The Sinkhorn CUDA kernel (``csrc/sinkhorn.cu``) against its plain PyTorch
version (``ops/emd.py::sinkhorn_ot_cost``) on the card, through both names.
Every test needs a CUDA device and skips without one. This file imports no
JAX, so it runs on a machine that has only PyTorch (tests/conftest.py
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sinkhorn_cuda.py

Tolerance everywhere: rtol 1e-4, atol 1e-5 (tests/test_kernels.py:35): the
same f32 terms summed in another order, in base 2 with ex2/lg2.approx.
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
from consistent__style_transfer_torch.utils.profiling import total  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _mask(rng, B, N, n_on, scatter):
    """(B, N) valid atoms: the first ``n_on`` slots, or ``n_on`` slots drawn
    anywhere (``scatter``: interior zeros); ``n_on="random"`` draws a count
    per row from [1, N]."""
    counts = rng.integers(1, N + 1, B) if n_on == "random" else np.full(B, n_on)
    mask = np.zeros((B, N), bool)
    for b, k in enumerate(counts):
        mask[b, rng.permutation(N)[:k] if scatter else slice(0, k)] = True
    return mask


def _inputs(seed, B, N, M, n_on=None, m_on=None, dim=100, scatter=False):
    """Histograms with zeros off the masks (``_mask``; no counts given: every
    atom valid) and the euclidean cost between unit vectors of ``dim``, as
    the WMD labeler builds it."""
    rng = np.random.default_rng(seed)
    p = rng.random((B, N)).astype(np.float32) + 0.05
    q = rng.random((B, M)).astype(np.float32) + 0.05
    p *= _mask(rng, B, N, N if n_on is None else n_on, scatter)
    q *= _mask(rng, B, M, M if m_on is None else m_on, scatter)
    p /= np.maximum(p.sum(-1, keepdims=True), 1e-9)
    q /= np.maximum(q.sum(-1, keepdims=True), 1e-9)
    x = rng.normal(size=(B, N, dim))
    y = rng.normal(size=(B, M, dim))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    diff = x[:, :, None, :] - y[:, None, :, :]
    D = np.sqrt(np.maximum((diff * diff).sum(-1), 1e-12)).astype(np.float32)
    return p, q, D


# (B, N, M, n_on, m_on, scatter)
SHAPES = {
    "yelp": (256, 27, 27, 20, 15, False),
    "book": (128, 45, 45, 40, 33, False),
    "ragged": (5, 9, 7, 7, 5, False),
    "single": (1, 27, 27, 9, 12, False),
    "cap": (3, 64, 64, 64, 50, False),
    "interior_zeros": (64, 27, 27, 12, 9, True),
    "interior_zeros_wide": (16, 64, 48, 40, 30, True),
    "rows_over_32": (8, 48, 27, 45, 20, True),
    "cols_over_32": (8, 27, 48, 20, 45, True),
    "n1": (8, 27, 27, 1, 20, True),
    "m1": (8, 27, 27, 20, 1, True),
    "n1_m1": (3, 9, 7, 1, 1, True),
    "b5": (5, 27, 27, 20, 15, False),
    "b257": (257, 27, 27, 20, 15, False),
    "cap_full": (4, 64, 64, 64, 64, False),
}


def _check_against_plain(got, ref, B):
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("entry", [sinkhorn_pallas, sinkhorn_pallas_cr],
                         ids=["sinkhorn_pallas", "sinkhorn_pallas_cr"])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_kernel_matches_plain(cuda_device, entry, shape):
    B, N, M, n_on, m_on, scatter = shape
    p, q, D = (torch.tensor(a, device=cuda_device)
               for a in _inputs(1, B, N, M, n_on, m_on, scatter=scatter))
    before = total("kernel.sinkhorn_cuda")
    got = entry(p, q, D)
    assert total("kernel.sinkhorn_cuda") == before + 1
    ref = sinkhorn_ot_cost(p, q, D)
    torch.cuda.synchronize()
    _check_against_plain(got, ref, B)


def test_random_sizes_match_plain(cuda_device):
    """Pairs of 1..40 atoms a side drawn anywhere, so that one launch runs
    every loop length of both paths, and B = 37, not a multiple of the pairs
    a block."""
    p, q, D = (torch.tensor(a, device=cuda_device)
               for a in _inputs(4, 37, 40, 40, "random", "random", scatter=True))
    got = sinkhorn_cuda(p, q, D)
    ref = sinkhorn_ot_cost(p, q, D)
    torch.cuda.synchronize()
    _check_against_plain(got, ref, 37)


def test_zero_iterations(cuda_device):
    """n_iters = 0: T = exp(logK) on the pair mask, potentials at 0."""
    p, q, D = (torch.tensor(a, device=cuda_device)
               for a in _inputs(5, 6, 12, 10, 8, 6, scatter=True))
    got = sinkhorn_pallas(p, q, D, n_iters=0)
    ref = sinkhorn_ot_cost(p, q, D, n_iters=0)
    torch.cuda.synchronize()
    _check_against_plain(got, ref, 6)


def _far_costs(p, q, D):
    """Costs 4x the labeler's (up to 8): some c * D below -100, where the
    kernel runs the exact form from the start."""
    return p, q, D * 4


def _tiny_masses(p, q, D):
    """One atom a side at mass ~1e-30: its potential sits some 100 (base 2)
    from the others', so the fast form's sums can leave their range."""
    for t in (p, q):
        t[:, 1] = 1e-30
        t /= t.sum(-1, keepdims=True)
    return p, q, D


@pytest.mark.parametrize("entry", [sinkhorn_pallas, sinkhorn_pallas_cr],
                         ids=["sinkhorn_pallas", "sinkhorn_pallas_cr"])
@pytest.mark.parametrize("case, epsilon", [(_far_costs, 0.05), (_tiny_masses, 0.05),
                                           (None, 0.01), (None, 0.2)],
                         ids=["far_costs", "tiny_masses", "eps0.01", "eps0.2"])
def test_fast_form_and_its_exact_rerun(cuda_device, entry, case, epsilon):
    """Inputs on which the product form's range flag or its K check sends a
    pair to the exact form, and other epsilons (0.01: c * D below -100 as
    well): the same numbers as the plain version to the tolerance."""
    arrays = _inputs(6, 40, 27, 27, 20, 15, scatter=True)
    p, q, D = (torch.tensor(a, device=cuda_device)
               for a in (case(*arrays) if case else arrays))
    got = entry(p, q, D, epsilon=epsilon)
    ref = sinkhorn_ot_cost(p, q, D, epsilon=epsilon)
    torch.cuda.synchronize()
    _check_against_plain(got, ref, 40)


def test_all_zero_pairs_give_zero(cuda_device):
    """A fallback row of the labeler (both histograms zeroed), a pair with one
    empty side (each way), and a normal pair beside them."""
    p, q, D = _inputs(2, 4, 27, 27, 10, 8, scatter=True)
    p[0], q[0] = 0, 0
    p[1] = 0
    q[2] = 0
    t = [torch.tensor(a, device=cuda_device) for a in (p, q, D)]
    for entry in (sinkhorn_pallas, sinkhorn_pallas_cr):
        got = entry(*t).cpu().numpy()
        ref = sinkhorn_ot_cost(*t).cpu().numpy()
        np.testing.assert_array_equal(got[:3], 0.0)
        assert np.isfinite(got).all() and got[3] > 0
        np.testing.assert_allclose(got, ref, **TOL)


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
