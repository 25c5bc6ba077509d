"""One-dispatch steps on the card: the port's counterpart of the JAX
package's ``jax.jit`` of a step (the optimize step, the warmup step, the
pretrain step per tower-flag tuple, serving's greedy transfer).

:class:`GraphedStep` runs ``fn(inputs, key)`` as CUDA graphs, one per branch
``key`` (optimize's ``do_apply``, pretrain's ``(cls, mat, dn)`` flags,
serving's input shape), as the JAX package compiles one program per static
argument. Each call copies ``inputs`` (a dict of tensors on the card, the
same names and shapes at every call of a branch) into the branch's static
buffers and replays its graph. The first call of a branch runs ``fn``
eagerly on a side stream (a real step, which also creates the lazy state:
Adam's moments, library workspaces, the decode head's shared-memory
attribute and tensor maps) and then captures it. A capture that fails
raises; nothing falls back to eager steps.

The ``torch.Generator``\\ s a step draws from (dropout, sched coins) are
registered with each graph, so every replay draws new masks and coins from
them, the same ones an eager step draws from the same generator states. A
call returns the graph's static outputs, which the next replay of that
branch overwrites: read or copy what must outlive it. Each graph keeps its
``cudaGraph_t`` (``keep_graph``), so its nodes can be counted; it is
instantiated at its first replay.

Each captured branch is kept in ``utils/profiling.py``'s recorder (always,
once a capture): the step's ``name``, the key, the host seconds of its
eager first call and of its capture, and its node count. When spans record
(``utils/profiling.py``), a call makes the spans ``step.copy_in`` (the
copies into the static buffers), ``step.replay`` (the replay and its launch
counts; its id is the branch's index in the recorder's ``graphs``) or
``step.first_call`` and ``step.capture``, and on the card a pair of CUDA
events times each replayed call (the copies and the replay) on the device.

The captures run in ``thread_local`` error mode: other threads go on
working on the card while one captures (the batch prefetcher's copies and,
in pretrain, its WMD labels with the Sinkhorn kernel). A step whose
capture must not overlap a thread's synchronous copy (pretrain's
:class:`~.state.AsyncSaver`, which copies the best weights to the host)
passes ``before_capture`` to drain it first. Python's cyclic garbage
collector is held off during a capture (:func:`gc_paused`): a collection
there may free a dead graph of an earlier step, and destroying a graph
while a stream captures invalidates that capture.

The hand-written kernels count their launches (``.launches`` on
:data:`COUNTED_KERNELS`). A call made while a stream captures launches
nothing and counts into ``.captured`` instead; a graph notes how many
calls of each kernel it captured and adds them to ``.launches`` at every
replay, so ``.launches`` counts the kernels that ran, eager or replayed.
When spans record, each replay also adds them to the recorder's counter
``kernel.<name>`` (the wrapper's name: ``kernel.lstm_cell_fwd``, ...,
``kernel.grouped_swiglu``, the expert layer's grouped products), and the
counts its capture made through ``utils/profiling.py::count_step``
(``moe.rows``).

:func:`step_runner` gives a stage one loop for both devices: a
:class:`GraphedStep` on the card, ``fn`` called eagerly on the CPU.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from typing import Callable, Hashable

import torch

from ..kernels.decode_step import fused_decode_logits
from ..kernels.lstm_cell import lstm_cell_bwd, lstm_cell_fwd
from ..kernels.sinkhorn import sinkhorn_cuda
from ..models.moe import grouped_swiglu
from ..utils import profiling
from ..utils.profiling import span

COUNTED_KERNELS = (fused_decode_logits, sinkhorn_cuda, lstm_cell_fwd, lstm_cell_bwd,
                   grouped_swiglu)


@contextmanager
def gc_paused():
    """The body runs with Python's automatic garbage collection off; the
    collector's state is restored after. Wrap a CUDA graph capture in it: a
    collection inside the capture would free whatever cyclic garbage waits
    (a dead ``GraphedStep``'s graphs among it; torch does not collect
    before a capture), and destroying a graph while a stream captures
    invalidates the capture, which then fails at its end."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class GraphedStep:
    """``fn(inputs, key)`` as one CUDA graph per ``key`` (see the module
    note). ``generators``: the explicit generators ``fn`` draws from (None
    entries are skipped). ``before_capture``: called before a branch's
    eager first call and capture. ``name``: the step's name in the
    recorder's graphs (default: ``fn``'s qualified name)."""

    def __init__(self, fn: Callable, generators=(), before_capture: Callable | None = None,
                 name: str | None = None, share_pool: bool = False):
        self.fn = fn
        # with share_pool every branch's graph takes its memory from one pool
        # (the first capture's): branches never run at once, and a call's
        # outputs are read before the next call of any branch overwrites them
        self.share_pool = share_pool
        self.pool = None
        self.name = name or getattr(fn, "__qualname__", type(fn).__name__)
        self.generators = tuple(g for g in generators if g is not None)
        self.before_capture = before_capture
        self.static: dict[Hashable, dict[str, torch.Tensor]] = {}
        self.graphs: dict[Hashable, torch.cuda.CUDAGraph] = {}
        self.outputs: dict[Hashable, object] = {}
        # per branch: (kernel wrapper, calls captured) for each counted kernel
        self.replay_launches: dict[Hashable, tuple] = {}
        # per branch: (counter, n) of each profiling.count_step its capture made
        self.replay_counts: dict[Hashable, tuple] = {}
        self.replays = 0  # of every branch
        self.branches: dict[Hashable, int] = {}  # key -> index in the recorder's graphs
        self.stream: torch.cuda.Stream | None = None

    def __call__(self, inputs: dict, key: Hashable = None):
        static = self.static.get(key)
        if static is None:
            static = self.static[key] = {k: torch.empty_like(v) for k, v in inputs.items()}
        graph = self.graphs.get(key)
        timed = graph is not None and profiling.recording()
        if timed:
            t_ns = time.perf_counter_ns()
            start = profiling.device_mark()
        with span("step.copy_in"):
            for k, buf in static.items():
                if inputs[k].shape != buf.shape:
                    raise ValueError(f"{k} is {tuple(inputs[k].shape)}; the step of {key!r} "
                                     f"takes {tuple(buf.shape)}")
                buf.copy_(inputs[k])
        if graph is None:
            return self._first_call(static, key)
        with span("step.replay", step=self.branches[key]):
            graph.replay()
            self.replays += 1
            for kernel, n in self.replay_launches[key]:
                kernel.launches += n
                profiling.count(f"kernel.{kernel.__name__}", n)
            for name, n in self.replay_counts.get(key, ()):
                profiling.count(name, n)
        if timed:
            profiling.device_step(start, t_ns)
        return self.outputs[key]

    def _first_call(self, static: dict, key: Hashable):
        if self.before_capture is not None:
            self.before_capture()
        device = next(iter(static.values())).device
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        side, current = self.stream, torch.cuda.current_stream(device)
        side.wait_stream(current)
        with span("step.first_call", always=True) as first, torch.cuda.stream(side):
            out = self.fn(static, key)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # its nodes can be counted
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [k.captured for k in COUNTED_KERNELS]
        profiling.RECORDER.step_counts = counts = []
        try:
            with span("step.capture", always=True) as capture, gc_paused(), torch.cuda.graph(
                    graph, pool=self.pool, stream=side, capture_error_mode="thread_local"):
                self.outputs[key] = self.fn(static, key)
        finally:
            profiling.RECORDER.step_counts = None
        self.replay_counts[key] = tuple(counts)
        if self.share_pool and self.pool is None:
            self.pool = graph.pool()
        self.replay_launches[key] = tuple(
            (k, k.captured - b) for k, b in zip(COUNTED_KERNELS, before) if k.captured > b)
        self.branches[key] = profiling.record_graph(self.name, key, first.seconds,
                                                    capture.seconds, profiling.graph_nodes(graph))
        self.graphs[key] = graph
        return out


def step_runner(fn: Callable, device: torch.device, generators=(),
                before_capture: Callable | None = None, name: str | None = None) -> Callable:
    """``runner(inputs, key=None)``: :class:`GraphedStep` of ``fn`` (named
    ``name``) on a CUDA ``device``; on the CPU ``fn(inputs, key)`` itself,
    eagerly."""
    if device.type == "cuda":
        return GraphedStep(fn, generators, before_capture, name)

    def eager(inputs: dict, key: Hashable = None):
        return fn(inputs, key)

    return eager
