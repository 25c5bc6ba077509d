"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.
The sources are in ``../csrc``; ``_build`` compiles them at first use."""
