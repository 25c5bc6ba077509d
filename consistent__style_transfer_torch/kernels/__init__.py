"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.
The sources are in ``../csrc``; ``_build`` compiles them at first use. Each
wrapper counts its launches as ``kernel.<wrapper name>`` through
``utils/profiling.py::count_step``, which replays a graph's captured
launches with the graph."""
