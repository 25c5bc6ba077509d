"""Host-side batch prefetcher: overlaps batch assembly and the host->device
copy with device compute.

A background thread walks a :class:`~.pipeline.BatchIterator` and moves each
batch's arrays to the device: on CUDA through pinned host memory with
``non_blocking=True``, so the copy is queued on the stream and the thread
goes on to the next batch.

Work that the collate itself queues on the card (the pretrain WMD labels:
histogram copies, the ground-cost tensor and the Sinkhorn kernel) arrives as
tensors already on the device and passes through unchanged. The producer
thread makes the consumer's current stream its own before it walks the
iterator, so the copies and the labeler's kernels are queued on the stream
the consumer computes on, and stream order puts each of them before the
compute that reads it: no event is needed.

``shard_fn`` (JAX ``data/prefetch.py:23-30``) keeps a data-parallel rank's
rows of each batch's arrays before the copy: ``parallel/sharding.py::
shard_batch``, or ``shard_stacked_batch`` for the optimize stage's (k, B,
...) groups.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .pipeline import Batch


def to_device(arrays: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """numpy arrays -> tensors on ``device`` (pinned, asynchronous on CUDA);
    tensors already on ``device`` pass through unchanged."""
    out = {}
    for k, a in arrays.items():
        if isinstance(a, torch.Tensor):
            out[k] = a.to(device)  # the tensor itself when it is there already
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DevicePrefetcher:
    """Iterate ``(Batch, device_tensors)`` with ``depth`` batches in flight."""

    def __init__(self, iterator, device: torch.device, depth: int = 2, shard_fn=None):
        self.iterator = iterator
        self.device = torch.device(device)
        self.depth = depth
        self.shard_fn = shard_fn

    def __iter__(self) -> Iterator[tuple[Batch, dict[str, torch.Tensor]]]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        errors: list[BaseException] = []
        stop = threading.Event()
        # the consumer's stream, made the producer's own (see the module note)
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)

        def producer():
            try:
                with torch.cuda.stream(stream):  # a no-op for None
                    for batch in self.iterator:
                        if stop.is_set():
                            return
                        arrays = batch.arrays if self.shard_fn is None else self.shard_fn(
                            batch.arrays)
                        q.put((batch, to_device(arrays, self.device)))
            except BaseException as e:  # surfaced in the consumer
                errors.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # a consumer that stops early must not leave the producer blocked
            # on a full queue
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if errors:
            raise errors[0]
