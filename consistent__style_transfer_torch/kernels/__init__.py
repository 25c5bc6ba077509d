"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.
The sources are in ``../csrc``; ``_build`` compiles them at first use."""

import torch


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``. On a
    stream that a CUDA graph is capturing the kernel is recorded, not run:
    the call counts in ``wrapper.captured``, and the graph adds its captured
    calls to ``.launches`` at each replay (``train/graphs.py``)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
