"""Batches and parameters over the ``(data, model)`` mesh: the port of the
JAX package's ``parallel/sharding.py``.

Data parallelism. Every rank builds the global batch, with the same host
noise draws, and keeps its rows: data index ``i`` of ``D`` takes rows
``[i*B/D, (i+1)*B/D)`` (:func:`batch_sharding`), the rows a JAX device of
that data index holds. Parameters are replicated (:func:`replicate`). The
gradients are averaged over the data group before the clip
(``train/state.py::AdamWithClip``), where XLA psums them before
``clip_by_global_norm``; validation adds up masked sums and counts
(:func:`global_masked_mean`), so every rank reads the same loss and takes
the same decision.

``DistributedDataParallel`` is not used: it averages in backward hooks and
broadcasts buffers every forward, while the stages here back-propagate into
a subset of the parameters (``backward(inputs=g_params)``), keep gradients
preallocated and zero them in place, and sum D's gradients over several
batches before one apply. One explicit all-reduce of one flat bucket, at the
optimizer's step, is the counterpart of the JAX psum in all three cases.

Tensor parallelism (:data:`TP_RULES`, :func:`param_shardings`,
:func:`shard_params`) puts the transformer attention and MLP weights and the
two vocabulary heads on DTensor ``Shard`` placements over the mesh's
``model`` dimension, everything else ``Replicate``; a model run under
``torch.distributed.tensor.experimental.implicit_replication`` then computes
with them and DTensor inserts the collectives, as XLA does from the JAX
shardings. Only ``parallel/exercise.py`` applies them, as in the JAX package.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

# (parameter-name regex, the dimension of the torch weight split over
# ``model``): JAX ``sharding.py:24-34`` with each kernel's spec transposed,
# since a flax kernel is (in, out) and a torch weight (out, in). First match
# wins; a dimension the model size does not divide stays replicated.
TP_RULES: list[tuple[str, int]] = [
    (r"self_attn\.in_proj_weight$", 0),    # P(None, "model") on (d, 3d)
    (r"self_attn\.in_proj_bias$", 0),      # P("model")
    (r"self_attn\.out_proj\.weight$", 1),  # P("model", None) on (d, d)
    (r"linear1\.weight$", 0),              # P(None, "model") on (d, ff)
    (r"linear1\.bias$", 0),
    (r"linear2\.weight$", 1),              # P("model", None) on (ff, d)
    (r"(^|\.)fwd\.weight$", 0),            # the LM vocab head
    (r"(^|\.)fwd\.bias$", 0),
    (r"(^|\.)fn_2\.weight$", 0),           # the generator vocab head
]


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_index(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("data")


def data_group(mesh):
    """The process group of this rank's data axis (the ranks that hold the
    other rows of its batches), or None without a mesh."""
    return None if mesh is None else mesh.get_group("data")


def batch_sharding(mesh, n_rows: int) -> slice:
    """The rows of a global batch of ``n_rows`` that this rank keeps. Raises
    unless the data size divides ``n_rows``."""
    D, i = data_size(mesh), data_index(mesh)
    if n_rows % D:
        raise ValueError(f"a batch of {n_rows} rows does not split over {D} data ranks")
    per = n_rows // D
    return slice(i * per, (i + 1) * per)


def shard_batch(arrays: dict, mesh) -> dict:
    """This rank's rows of every (B, ...) array or tensor in ``arrays``
    (views, not copies); the dict itself without a mesh."""
    if mesh is None:
        return arrays
    rows = batch_sharding(mesh, len(next(iter(arrays.values()))))
    return {k: v[rows] for k, v in arrays.items()}


def shard_stacked_batch(arrays: dict, mesh) -> dict:
    """:func:`shard_batch` on axis 1 of a stacked (k, B, ...) group
    (``data/pipeline.py::MegaBatches``): every rank walks all k steps."""
    if mesh is None:
        return arrays
    rows = batch_sharding(mesh, next(iter(arrays.values())).shape[1])
    return {k: v[:, rows] for k, v in arrays.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place.
    Every rank builds the same seeded weights, so this is a guard run once a
    stage, not a copy on the hot path."""
    if mesh is not None:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_reduce_mean(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` in place over ``group`` with one collective on one
    flat bucket (per dtype), not one per tensor. Queued on the current
    stream with no host sync, so it can be captured in a CUDA graph."""
    if group is None or not tensors:
        return
    n = dist.get_world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


def global_means(metrics: dict, group) -> dict:
    """``metrics``, a rank's means over its rows of a training batch (0-dim
    tensors), as means over the global batch, which is what a one-process
    run logs: averaged over ``group`` (the ranks hold equal rows of such a
    batch) in one collective, which every rank must call. Unchanged without
    a group."""
    if group is None or not metrics:
        return metrics
    flat = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
    all_reduce_mean([flat], group)
    return dict(zip(metrics, flat.unbind()))


def global_masked_mean(sums: list[torch.Tensor], count: float, group) -> list[float]:
    """``sums[j] / count`` over the whole data group: each rank passes its
    masked sums and its count of real rows, and one all-reduce adds them up,
    so ranks with unequal real rows (a padded last batch) weigh right and
    all read the same numbers. Without a group, ``float(s) / max(count, 1)``."""
    if group is None:
        return [float(s) / max(count, 1) for s in sums]
    device = sums[0].device if sums else torch.device("cpu")
    packed = torch.stack([s.double().reshape(()) for s in sums]
                         + [torch.tensor(float(count), dtype=torch.float64, device=device)])
    dist.all_reduce(packed, group=group)
    total = max(float(packed[-1]), 1.0)
    return [float(v) / total for v in packed[:-1]]


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every data rank's rows of ``t`` in data order (the global
    batch back from its shards); ``t`` itself without a group."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def param_shardings(module: torch.nn.Module, mesh, rules=None) -> dict:
    """{parameter name: DTensor placements over the mesh's ``model``
    dimension}: ``Shard(dim)`` where a rule of :data:`TP_RULES` matches, the
    model size is above 1 and divides that dimension; ``Replicate()``
    otherwise (JAX ``sharding.py:41-63``)."""
    from torch.distributed.tensor import Replicate, Shard

    rules = TP_RULES if rules is None else rules
    m = 1 if mesh is None else mesh.size(1)
    out = {}
    for name, p in module.named_parameters():
        placement = Replicate()
        if m > 1:
            for pattern, dim in rules:
                if re.search(pattern, name):
                    if p.shape[dim] % m == 0:
                        placement = Shard(dim)
                    break
        out[name] = (placement,)
    return out


@torch.no_grad()
def shard_params(module: torch.nn.Module, mesh, rules=None) -> torch.nn.Module:
    """Lay ``module``'s parameters out over the mesh's ``model`` dimension
    with the placements of :func:`param_shardings`, in place: each becomes a
    DTensor. Every rank must hold the same full values (seeded weights).

    A module none of whose parameters a rule shards (the classifier, D)
    keeps plain tensors, which are its replicated layout: hooks gather the
    DTensors it is given (a sharded module's outputs) into whole tensors and
    hand its outputs on as replicated DTensors, so its ops (``unfold``, the
    convolutions) need no DTensor rule, forward or backward, and it computes
    what a replicated module computes."""
    from torch.distributed.tensor import distribute_tensor

    sub = mesh["model"]
    placements = param_shardings(module, mesh, rules)
    if not any(pl.is_shard() for pls in placements.values() for pl in pls):
        module.register_forward_pre_hook(_gather_inputs, with_kwargs=True)
        module.register_forward_hook(lambda m, args, out: _as_replicated(out, sub))
        return module
    for name, pls in placements.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        p = getattr(owner, attr)
        dt = distribute_tensor(p.data, sub, list(pls))
        setattr(owner, attr, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def _gather_inputs(module, args, kwargs):
    return (tuple(full_tensor(a) for a in args),
            {k: full_tensor(v) for k, v in kwargs.items()})


def _as_replicated(out, sub_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(out, torch.Tensor) and not isinstance(out, DTensor):
        return DTensor.from_local(out, sub_mesh, [Replicate()], run_check=False)
    return out


def full_tensor(t):
    """The whole tensor of a DTensor (gathered over its mesh; differentiable),
    else ``t``."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def local_tensor(t):
    """The local shard of a DTensor (sharing its storage), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t
