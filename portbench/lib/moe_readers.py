"""Per-layer readers of the LFM2-8B-A1B optimize cell
(``drivers/optimize_lfm2.py``): its grouped expert products in the device
trace and their share of the roofline."""

from portbench.lib.trace import union

# torch._grouped_mm's CUTLASS kernels on sm_90 (models/moe.py::grouped_swiglu)
KERNELS = ("GroupProblemShape",)


def gmm_ms(r):
    """Device ms a traced step spends in the grouped expert products,
    forward and backward: the union of their intervals over the traced
    steps. None where the trace has no such kernel."""
    trace, n = r.get("trace"), r.get("trace_steps")
    if trace is None or not n:
        return None
    events = trace.named(*KERNELS)
    if not events:
        return None
    return sum(e - s for s, e in union((s, e) for s, e, _ in events)) / n * 1e3


def gmm_roofline(r):
    """100 x the least time of a step's grouped products
    (``counts/moe.py::gmm_bound_ms``, read by the driver) over
    :func:`gmm_ms`."""
    ms, bound = gmm_ms(r), r.get("gmm_bound_ms")
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
