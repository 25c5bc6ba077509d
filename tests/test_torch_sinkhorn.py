"""The port's plain Sinkhorn (``ops/emd.py::sinkhorn_ot_cost``, the plain
version of the CUDA kernel) and its CPU entries (``kernels/sinkhorn.py``)
against the JAX package's jnp ``sinkhorn_ot_cost`` and its two Pallas kernels
in interpret mode, on the shapes of tests/test_kernels.py and on the yelp
label shape with an all-zero pair. rtol 1e-4, atol 1e-5: the same float32
terms, summed in another order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.kernels.sinkhorn import (  # noqa: E402
    sinkhorn_pallas as jax_sinkhorn_pallas,
)
from consistent__style_transfer_tpu.kernels.sinkhorn import (  # noqa: E402
    sinkhorn_pallas_cr as jax_sinkhorn_pallas_cr,
)
from consistent__style_transfer_tpu.ops.emd import exact_ot_cost as jax_exact_ot_cost  # noqa: E402
from consistent__style_transfer_tpu.ops.emd import sinkhorn_ot_cost as jax_sinkhorn  # noqa: E402
from consistent__style_transfer_torch.kernels.sinkhorn import (  # noqa: E402
    sinkhorn_cuda,
    sinkhorn_pallas,
    sinkhorn_pallas_cr,
)
from consistent__style_transfer_torch.ops.emd import exact_ot_cost, sinkhorn_ot_cost  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, B, N, M, n_on, m_on, dim=3):
    """tests/test_kernels.py's construction: zero tails, normalised masses,
    euclidean costs between random points."""
    rng = np.random.default_rng(seed)
    p = rng.random((B, N)).astype(np.float32)
    q = rng.random((B, M)).astype(np.float32)
    p[:, n_on:] = 0
    q[:, m_on:] = 0
    p /= p.sum(-1, keepdims=True)
    q /= q.sum(-1, keepdims=True)
    x = rng.normal(size=(B, N, dim))
    y = rng.normal(size=(B, M, dim))
    D = np.linalg.norm(x[:, :, None] - y[:, None, :], axis=-1).astype(np.float32)
    return p, q, D


def _yelp_with_zero_pair():
    p, q, D = _inputs(7, 4, 27, 27, 20, 15, dim=100)
    p[1], q[1] = 0, 0  # a fallback row of the labeler
    return p, q, D


CASES = {
    "kernels_8x8": (_inputs(0, 4, 8, 8, 6, 5), 50),      # test_kernels.py:20
    "kernels_9x7": (_inputs(2, 5, 9, 7, 7, 5), 50),      # test_kernels.py:38
    "yelp_zero_pair": (_yelp_with_zero_pair(), 100),
}


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_jnp(case):
    arrays, iters = CASES[case]
    ref = np.asarray(jax_sinkhorn(*arrays, epsilon=0.05, n_iters=iters))
    got = sinkhorn_ot_cost(*_torch(arrays), epsilon=0.05, n_iters=iters).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("entry, jax_entry", [(sinkhorn_pallas, jax_sinkhorn_pallas),
                                              (sinkhorn_pallas_cr, jax_sinkhorn_pallas_cr)],
                         ids=["sinkhorn_pallas", "sinkhorn_pallas_cr"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_entries_match_pallas_interpret(entry, jax_entry, case):
    """On CPU tensors both names run the plain version and launch nothing."""
    arrays, iters = CASES[case]
    ref = np.asarray(jax_entry(*arrays, epsilon=0.05, n_iters=iters, interpret=True))
    before = sinkhorn_cuda.launches
    got = entry(*_torch(arrays), epsilon=0.05, n_iters=iters).numpy()
    assert sinkhorn_cuda.launches == before
    np.testing.assert_allclose(got, ref, **TOL)


def test_zero_pair_gives_zero_not_nan():
    arrays, _ = CASES["yelp_zero_pair"]
    got = sinkhorn_ot_cost(*_torch(arrays)).numpy()
    assert np.isfinite(got).all() and got[1] == 0.0


def test_exact_ot_cost_matches_jax():
    (p, q, D), _ = CASES["kernels_9x7"]
    for b in range(len(p)):
        n, m = int((p[b] > 0).sum()), int((q[b] > 0).sum())
        args = (p[b, :n], q[b, :m], D[b, :n, :m])
        assert exact_ot_cost(*args) == pytest.approx(jax_exact_ot_cost(*args), rel=1e-12)
    assert exact_ot_cost(np.zeros(0), q[0], D[0, :0]) == float("inf")


def test_cuda_entry_refuses_cpu_tensors():
    arrays, _ = CASES["kernels_8x8"]
    with pytest.raises(ValueError, match="cuda"):
        sinkhorn_cuda(*_torch(arrays))
