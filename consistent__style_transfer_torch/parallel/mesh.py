"""The process group and the ``(data, model)`` device mesh: the port of the
JAX package's ``parallel/mesh.py``.

The JAX package builds ``Mesh(("data", "model"))`` over the devices of one
program and lets XLA insert the collectives. The port runs one process per
GPU under the PyTorch launcher::

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m consistent__style_transfer_torch <command> ... [--n_data D --n_model M]

:func:`init_distributed` joins the group the launcher describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``): NCCL for a CUDA device, each rank on
``cuda:LOCAL_RANK``, gloo for the CPU. :func:`make_mesh` lays the ranks out
as ``arange(world).reshape(D, M)``, as the JAX package reshapes its device
list, so rank ``r`` has data index ``r // M`` and model index ``r % M``.
Without the launcher there is no group: every command runs in one process,
with no collective, and any mesh but ``1 x 1`` raises.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_MESHES: dict = {}


def world_size() -> int:
    """The number of ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    """True on rank 0 (and in a run without a group): the rank that writes
    files, logs and prints."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if world_size() > 1:
        dist.barrier()


def mesh_shape(n_data: int | None, n_model: int, world: int) -> tuple[int, int]:
    """``(D, M)`` for a world of ``world`` ranks, ``n_data=None`` giving
    ``world // n_model``. Raises unless ``D * M == world``."""
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh sizes must be positive, got n_data={n_data}, n_model={n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        hint = "" if world > 1 else " (one process: start it under torch.distributed.run)"
        raise ValueError(f"a {n_data} x {n_model} (data x model) mesh needs {n_data * n_model} "
                         f"ranks, the world has {world}{hint}")
    return n_data, n_model


def init_distributed(cfg, init_method: str | None = None) -> bool:
    """Join the launcher's process group for ``cfg`` and return True, or
    return False when there is nothing to join: no ``WORLD_SIZE`` in the
    environment, or a group made already by the caller. Either way the mesh
    ``cfg.mesh`` asks for must fit the world, or this raises.

    A CUDA ``cfg.device`` takes NCCL, bound to ``cuda:LOCAL_RANK`` (made
    the current device); ``cpu`` takes gloo. ``init_method`` defaults to
    the launcher's ``env://`` rendezvous."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        mesh_shape(cfg.mesh.n_data, cfg.mesh.n_model, world_size())
        return False
    world, rnk = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rnk))
    mesh_shape(cfg.mesh.n_data, cfg.mesh.n_model, world)
    kw = {}
    if torch.device(cfg.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu (gloo) to run the "
                               "ranks on the CPU")
        torch.cuda.set_device(local)
        backend, kw["device_id"] = "nccl", torch.device("cuda", local)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rnk,
                            world_size=world, timeout=timedelta(minutes=30), **kw)
    return True


def destroy_distributed() -> None:
    """Leave the process group (a no-op without one) and forget its meshes."""
    _MESHES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str | None = None):
    """The ``(data, model)`` ``DeviceMesh`` over the process group, or None
    when there is no group (one process; then only ``1 x 1`` fits). Its
    device type is ``device_type``, or by default the group's own: ``cuda``
    over NCCL, ``cpu`` over gloo. One mesh per shape is made and kept, so
    stages chained in one run share its sub-groups."""
    D, M = mesh_shape(n_data, n_model, world_size())
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (D, M, device_type)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        _MESHES[key] = init_device_mesh(device_type, (D, M), mesh_dim_names=("data", "model"))
    return _MESHES[key]
