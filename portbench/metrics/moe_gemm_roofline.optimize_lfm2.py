"""`moe_gemm_roofline.optimize_lfm2`: the grouped expert products' share of
their roofline: the least time of a step's products for the routed rows'
FLOPs at 989 TFLOP/s (bf16) or the expert weights' and rows' bytes at 3.35
TB/s, whichever is longer, summed product by product
(``counts/moe.py::gmm_bound_ms``, from the configuration, so the same work
is read whatever implements it), over their traced device time a step
(``lib/moe_readers.py``)."""

from portbench.lib.moe_readers import gmm_roofline as read  # noqa: F401
