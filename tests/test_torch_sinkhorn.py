"""The port's plain Sinkhorn (``ops/emd.py::sinkhorn_ot_cost``, the plain
version of the CUDA kernel) and its CPU entries (``kernels/sinkhorn.py``)
against the JAX package's jnp ``sinkhorn_ot_cost`` and its two Pallas kernels
in interpret mode, on the shapes of tests/test_kernels.py, on the yelp label
shape with an all-zero pair, and on masks with interior zeros (the valid
atoms not a prefix, which the CUDA kernel compacts). rtol 1e-4, atol 1e-5:
the same float32 terms, summed in another order. Also the arithmetic of
``chip_smoke.py::sinkhorn_bound`` on hand-counted masks."""

import importlib.util
import os

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
from consistent__style_transfer_torch.utils.profiling import total  # noqa: E402

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


def _interior_zeros():
    """Zero masses inside each row, not only a tail: rows of 27 slots with
    3-12 valid atoms anywhere, one row with a single atom a side in the
    middle, one with one side empty."""
    rng = np.random.default_rng(11)
    p, q, D = _inputs(11, 5, 27, 27, 27, 27, dim=100)
    for t in (p, q):
        for b in range(len(t)):
            t[b, rng.permutation(27)[: 27 - rng.integers(3, 13)]] = 0
    p[3], q[3] = 0, 0
    p[3, 13], q[3, 20] = 1, 1
    q[4] = 0
    p /= np.maximum(p.sum(-1, keepdims=True), 1e-9)
    q /= np.maximum(q.sum(-1, keepdims=True), 1e-9)
    return p, q, D


CASES = {
    "kernels_8x8": (_inputs(0, 4, 8, 8, 6, 5), 50),      # test_kernels.py:20
    "kernels_9x7": (_inputs(2, 5, 9, 7, 7, 5), 50),      # test_kernels.py:38
    "yelp_zero_pair": (_yelp_with_zero_pair(), 100),
    "interior_zeros": (_interior_zeros(), 100),
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
    before = total("kernel.sinkhorn_cuda")
    got = entry(*_torch(arrays), epsilon=0.05, n_iters=iters).numpy()
    assert total("kernel.sinkhorn_cuda") == before
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


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_interior_zero_masks_are_not_prefixes():
    (p, q, _), _ = CASES["interior_zeros"]
    for t in (p, q):
        on = t > 0
        assert any(row.any() and not row[: row.sum()].all() for row in on)


@pytest.mark.parametrize("case", ["special_function_binds", "bytes_bind"])
def test_sinkhorn_bound_arithmetic(case):
    """Counted by hand: pair 0 keeps atoms {0, 2} x {0} (2 valid terms, 3
    atoms); pair 1 has an empty side, so it costs nothing but its bytes. The
    terms: bytes (p, q, D read, the costs written), one multiply-add (2 flop)
    per valid term of each of the 200 half-iterations, and one exp and one
    log per atom of a live pair in each half-iteration, plus 2 exps per
    valid term (E and the plan) and one log per atom (the masses); the
    largest binds."""
    cs = _chip_smoke()
    p = torch.tensor([[0.5, 0.0, 0.5], [0.2, 0.3, 0.5]])
    q = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    if case == "bytes_bind":
        p = torch.zeros(2, 3)
    got = cs.sinkhorn_bound(p, q)
    valid, atoms = (2, 3) if case == "special_function_binds" else (0, 0)
    nbytes = (2 * 3 + 2 * 2 + 2 * 3 * 2 + 2) * 4
    assert got["bytes"] == nbytes == 96
    assert got["valid_terms_per_iter"] == valid and got["live_atoms"] == atoms
    assert got["fma_flop"] == 2 * 2 * 100 * valid
    sfu = 2 * 100 * atoms + 2 * valid + atoms
    assert got["special_function_ops"] == sfu == (607 if valid else 0)
    assert got["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert got["fma_ms"] == pytest.approx(400 * valid / 67e12 * 1e3, rel=1e-12)
    sfu_ms = sfu / (16 * 132 * 1.98e9) * 1e3
    assert got["special_function_ms"] == pytest.approx(sfu_ms, rel=1e-12)
    want = "special_function" if case == "special_function_binds" else "bytes"
    assert got["bound_term"] == want
    assert got["bound_by"] == ("operations" if want != "bytes" else "bytes")
    assert got["bound_ms"] == max(got["bytes_ms"], got["fma_ms"], got["special_function_ms"])
