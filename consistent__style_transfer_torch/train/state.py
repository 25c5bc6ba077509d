"""Optimizer and checkpoint runtime: the port of the JAX package's
``train/state.py``.

The port's checkpoints are the reference's own format: ``.pth`` state dicts
(per-task ``{cls,mat,dn}.pth`` of pretrain, ``G.pth``, ``G_epoch_<n>.pth``),
the files the JAX package writes through ``utils/torch_interop.py::save_pth``.
"""

from __future__ import annotations

import glob
import os
import queue
import threading

import torch
import torch.distributed as dist

from ..parallel.sharding import all_reduce_mean, local_tensor


class AdamWithClip:
    """``optax.chain(clip_by_global_norm(clip), adam(lr, 0.9, 0.999, 1e-8))``,
    the optimizer of every reference stage, over ``params``.

    The clip is optax's: when the global norm of all gradients is at least
    ``clip``, every gradient becomes ``(g / norm) * clip``; below it they stay
    as they are (``clip_grad_norm_`` would add 1e-6 to the norm). It runs on
    the device, with no host sync. Then ``torch.optim.Adam``.

    Every parameter holds a gradient from the start and :meth:`zero_grad`
    zeroes it in place, never to None, so a tower whose loss is off still
    takes an Adam step on zero gradients, moving on its decaying moments, and
    every parameter's step count is the global one, as under optax.

    With a data ``group`` (``parallel/sharding.py::data_group``) the step
    first averages the gradients over it, one all-reduce of one flat bucket,
    so the clip sees the norm of the global batch's gradient, as the JAX
    package psums before ``clip_by_global_norm``. Parameters that are
    DTensors (``parallel/sharding.py::shard_params``) are averaged on their
    local shards; the norm adds the squares of a ``Shard``ed gradient over
    its mesh's group and counts a ``Replicate``d one once.

    On the card the Adam is ``capturable``: its step count lives on the
    device and the update reads nothing back to the host, so a step, its
    all-reduce included, can run inside a CUDA graph (the optimize stage);
    eager steps take the same path. On the card it is also the fused Adam,
    one kernel over all the parameters, which holds no temporaries the size
    of the moments (the multi-tensor path's would be 9.4 GB in each
    captured graph's memory at LFM2-8B-A1B's 2.34B parameters). On the CPU,
    where ``capturable`` is refused, it is the plain Adam."""

    def __init__(self, params, lr: float, clip: float, group=None):
        self.params = list(params)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip = clip
        self.group = group
        cuda = self.params[0].is_cuda
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     capturable=cuda, fused=cuda or None)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=False)

    def state_dict(self) -> dict:
        """The Adam state (moments and step counts) and its hyperparameters."""
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)

    def _global_norm(self, grads: list) -> torch.Tensor:
        """The norm of the whole gradient: over the local tensors, plus, for
        DTensor gradients with a ``Shard`` placement, the squares of the
        other shards, summed over their mesh's group."""
        sharded = [g for g in grads if any(pl.is_shard() for pl in
                                           getattr(g, "placements", ()))]
        if not sharded:
            return torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm([local_tensor(g) for g in grads])))
        whole = [local_tensor(g) for g in grads if not any(g is s for s in sharded)]
        parts = [local_tensor(g) for g in sharded]
        sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(parts))) ** 2
        dist.all_reduce(sq, group=sharded[0].device_mesh.get_group())
        if whole:
            sq = sq + torch.linalg.vector_norm(torch.stack(torch._foreach_norm(whole))) ** 2
        return sq.sqrt()

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:  # a DTensor gradient in the parameter's layout
            if hasattr(p.grad, "placements") and p.grad.placements != p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        grads = [local_tensor(p.grad) for p in self.params]
        all_reduce_mean(grads, self.group)
        norm = self._global_norm([p.grad for p in self.params])
        clipped = norm >= self.clip
        torch._foreach_div_(grads, torch.where(clipped, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clipped, self.clip, 1.0).to(norm))
        self.adam.step()


def save_state_dict(state_dict: dict, path: str) -> None:
    """Write a state dict as a ``.pth`` file (CPU tensors), atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def load_state_dict(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def params_exist(path: str) -> bool:
    return os.path.exists(path)


class AsyncSaver:
    """Best-weight saves off the epoch-end critical path: one FIFO worker
    thread does the device->host copy and the disk write, so writes to one
    path keep submission order.

    Torch parameters change in place (JAX arrays do not, which the JAX
    package's saver relies on), so :meth:`submit` snapshots the state dict
    when it is called: a copy on the device, queued on the current stream
    before the next step's update, with an event the worker waits for before
    it copies to the host.

    :meth:`wait` drains the queue and re-raises the first worker error; call
    it before anything reads the saved files."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is not None:
                    fn()
            except BaseException as e:  # surfaced on wait()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()
            if fn is None:
                return

    def submit(self, module: torch.nn.Module, path: str, delete_path: str | None = None) -> None:
        """Queue a save of ``module``'s weights as they are now; then, on the
        worker, delete ``delete_path`` (the previous best) if it is another
        file that exists."""
        snapshot = {k: v.detach().clone() for k, v in module.state_dict().items()}
        ready = None
        if any(v.is_cuda for v in snapshot.values()):
            ready = torch.cuda.Event()
            ready.record()

        def work():
            if ready is not None:
                ready.synchronize()
            save_state_dict(snapshot, path)
            if delete_path and delete_path != path and os.path.exists(delete_path):
                os.remove(delete_path)

        self._q.put(work)

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self._q.put(None)
        self.wait()
        self._t.join()


class BestKeeper:
    """Save-on-improvement of a loss, with optional previous-best deletion
    (the optimize stage's ``G_epoch_<n>`` retention,
    ``src/main_optimize.py:144-151``). With ``saver``, the save and the
    delete run on its worker thread, off the epoch-end critical path;
    without, here. With ``write`` false (every rank but 0 of a
    data-parallel run) it keeps the best and its path but touches no file."""

    def __init__(self, saver: AsyncSaver | None = None, write: bool = True):
        self.best = float("inf")
        self.last_path: str | None = None
        self._saver = saver
        self._write = write

    def update(self, value: float, module: torch.nn.Module, path: str,
               delete_previous: bool = False) -> bool:
        if not value < self.best:
            return False
        self.best = value
        delete = (self.last_path if delete_previous and self.last_path
                  and self.last_path != path else None)
        if not self._write:
            pass
        elif self._saver is not None:
            self._saver.submit(module, path, delete_path=delete)
        else:
            save_state_dict(module.state_dict(), path)
            if delete and os.path.exists(delete):
                os.remove(delete)
        self.last_path = path
        return True


def newest_checkpoint(dump_dir: str, pattern: str = "G_epoch_*.pth") -> str | None:
    """Reference test-mode resolution: the lexicographically newest file in
    the task dump dir (``src/main_optimize.py:47-54``; so ``G_epoch_9`` sorts
    after ``G_epoch_10``, as there)."""
    files = sorted(glob.glob(os.path.join(dump_dir, pattern)))
    return files[-1] if files else None
