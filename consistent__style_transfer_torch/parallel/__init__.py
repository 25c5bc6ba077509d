"""Data parallelism and the ``(data, model)`` mesh on ``torch.distributed``:
the port of the JAX package's ``parallel/``."""

from .mesh import make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    batch_sharding,
    param_shardings,
    replicate,
    shard_batch,
)
