"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W limit) and the least time of the Sinkhorn kernel for the work
its inputs need. Copied from ``chip_smoke.py`` (``PEAK_*``,
``sinkhorn_bound``) so that a later change to the program
cannot move the yardstick.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}
# special-function units (exp2, log2): 16 results per SM per clock (CUDA C++
# Programming Guide, compute capability 9.0), 132 SMs at 1.98 GHz boost
PEAK_SFU_S = 16 * 132 * 1.98e9
SINKHORN_ITERS = 100


def sinkhorn_bound(n_atoms, m_atoms, N: int, M: int) -> dict:
    """Least ms of one Sinkhorn call of B pairs, padded to N and M atoms,
    whose valid atoms are ``n_atoms`` and ``m_atoms`` (length-B sequences):
    the largest of the bytes (masses, ground costs read once, the costs
    written once) at the HBM rate; one multiply-add per valid (i, j) term of
    each of the 2 * iterations half-steps at the float32 peak; and one exp
    and one log per valid atom a half-step, one exp per valid term for the
    kernel and one for the plan, and one log per valid atom for the masses,
    at the special-function rate. Pairs with no valid term cost nothing."""
    B = len(n_atoms)
    valid = sum(n * m for n, m in zip(n_atoms, m_atoms))
    atoms = sum((n + m) for n, m in zip(n_atoms, m_atoms) if n * m > 0)
    nbytes = (B * N + B * M + B * N * M + B) * 4
    fma = 2 * 2 * SINKHORN_ITERS * valid
    sfu = 2 * SINKHORN_ITERS * atoms + 2 * valid + atoms
    ms = {"bytes": nbytes / PEAK_BYTES_S * 1e3, "fma": fma / PEAK_OPS_S["float32"] * 1e3,
          "special_function": sfu / PEAK_SFU_S * 1e3}
    term = max(ms, key=ms.get)
    return {"bound_ms": ms[term], "bound_term": term, "bytes": nbytes, "fma_flop": fma,
            "special_function_ops": sfu}
