"""The WMD labeler's Sinkhorn kernel's share of its roofline, kernel
``csrc/sinkhorn.cu``: the least time of a call for its work
(``counts/roofline.py::sinkhorn_bound``, over the valid atoms of each pair,
which the harness works out from the traced batches' noised ids as the
reference labeler forms the masses), over the kernel's time per call in
the trace (the union of its intervals over the calls found). The bound is
averaged over the batches the traced part of the window consumed; the
kernel's calls there label the batches the prefetcher makes at the time,
one or two ahead, which have the same sizes."""

from portbench.counts.roofline import sinkhorn_bound
from portbench.lib.trace import union

KERNEL = "sinkhorn_kernel"


def read(r):
    trace, atoms = r.get("trace"), r.get("sinkhorn_atoms")
    if trace is None or not atoms:
        return None
    events = trace.named(KERNEL)
    if not events:
        return None
    N, M = r["sinkhorn_padded"]
    bound_ms = sum(sinkhorn_bound(n, m, N, M)["bound_ms"] for n, m in atoms) / len(atoms)
    busy = sum(e - s for s, e in union((s, e) for s, e, _ in events))
    return 100.0 * bound_ms / (busy / len(events) * 1e3)
