"""`moe_gemm_ms.optimize_lfm2`: device ms a traced optimize step spends in
the grouped expert products of the LFM2-8B-A1B generator
(``models/moe.py::grouped_swiglu``: ``torch._grouped_mm``, forward and
backward), found by kernel name in the trace (``lib/moe_readers.py``)."""

from portbench.lib.moe_readers import gmm_ms as read  # noqa: F401
