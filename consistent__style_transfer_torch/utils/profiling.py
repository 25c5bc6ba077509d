"""Profiling hooks: the port of the JAX package's ``utils/profiling.py``. A
``torch.profiler`` trace of any block (host and, on the card, device
activity), written as a Chrome trace that Perfetto or ``chrome://tracing``
opens, a step-time summary, and the program's own spans and counters.

``trace`` is on when ``TPUST_TRACE=1`` (or ``enabled=True``), off otherwise,
and then costs nothing; the trace goes to ``log_dir``, else
``$TPUST_TRACE_DIR``, else ``log/trace``. The CLI wraps every command in it.

``report_launches`` (on when ``TPUST_KERNEL_COUNTS=1``) prints, after a CLI
command, one JSON line to stderr with the rank, the command's seconds and
the launch counts of the port's kernels in this process: a process started
by the launcher counts its own launches, which no caller can read
otherwise.

**Spans and counters** (:data:`RECORDER`). ``with span(name, step=, batch=)``
around a layer's work records (name, start ns, end ns, its sequence number,
its parent's, the step, batch or graph-branch id, thread name) on the
``time.perf_counter_ns`` clock, the clock of the benchmark's spans and of
its device trace (``portbench/lib/trace.py``). The parent is the innermost
span open on the same thread; a batch id (:func:`next_batch_id`) ties the
prefetcher thread's spans of a batch to the consumer's take of it.
``count(name, n)`` records (name, time ns, n). Both record while a
``torch.profiler`` is active (its process-wide flag, which every thread
sees) or when ``TPUST_SPANS=1``, and are off otherwise: a site then costs
one flag check, with no allocation, no CUDA call and no
``record_function``. While a profiler is active a span also enters
``torch.profiler.record_function(name)``, so a Chrome trace shows the
program's spans beside its kernels. A span made with ``always=True`` (the
stage loops' ``epoch`` and ``validate``, a graph's first call and capture:
once an epoch or a capture) is timed and recorded whether on or not, and
gives its ``seconds``.

Kept always, once a capture: :data:`RECORDER`'s ``graphs``, one entry per
captured branch of a ``train/graphs.py::GraphedStep`` (its step's name, the
branch key, the eager first call's and the capture's host seconds, the
graph's node count), readable after the step objects are gone, as the
kernels' ``.launches`` are. On the card, when on, each replayed call (its
copies into the static buffers and the replay) is timed on the device by a
pair of CUDA events; the pairs are read once done, at a later replay or
the stage's next sync (:func:`read_device_times`, which never waits), as
the counters ``step.device_ms`` and ``step.gap_ms`` (the device time from
the previous timed call's end to this one's start), stamped with the
call's host start.

With ``TPUST_SPANS=1`` the process writes its spans, counters and graphs
to ``$TPUST_TRACE_DIR/spans-<pid>.json`` (default ``log/trace``) at exit
and prints a summary line to stderr: count, total ms and mean ms of each
span name, count, total and mean of each counter.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import ctypes
import functools
import itertools
import json
import os
import sys
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_FIELDS = ("name", "start_ns", "end_ns", "seq", "parent", "id", "thread")
COUNTER_FIELDS = ("name", "t_ns", "n")
NVML_CLOCK_SM = 1


@contextlib.contextmanager
def trace(log_dir: str | None = None, enabled: bool | None = None):
    """Profile the enclosed block when enabled; yields the profiler (None
    when off). The trace is written to ``<log_dir>/trace-<pid>-<time>.json``
    when the block ends."""
    if enabled is None:
        enabled = os.environ.get("TPUST_TRACE", "0") == "1"
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.environ.get("TPUST_TRACE_DIR", "log/trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{int(time.time())}.json"))


class Recorder:
    """The process's spans, counters, captured graphs and pending device
    timings (see the module note). ``env``: ``TPUST_SPANS=1`` when made."""

    def __init__(self):
        self.env = os.environ.get("TPUST_SPANS", "0") == "1"
        self.spans: list[tuple] = []  # SPAN_FIELDS
        self.counters: list[tuple] = []  # COUNTER_FIELDS
        self.graphs: list[dict] = []
        self.pending: collections.deque = collections.deque()  # (start, end, t_ns)
        self.last_end = None  # the newest read replay's end event
        self.spare_events: list = []
        self.sm_clock: int | None = None  # the newest sm_clock_mhz reading
        self.step_counts: list | None = None  # count_step's, while a graph captures
        self.local = threading.local()
        self.seq = itertools.count()
        self.batch_ids = itertools.count()

    def clear(self) -> None:
        """Forget every span, counter and device timing (not the graphs)."""
        self.spans.clear()
        self.counters.clear()
        self.pending.clear()
        self.last_end = None

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def summary(self) -> dict:
        spans, counters = {}, {}
        for name, a, b, *_ in self.spans:
            s = spans.setdefault(name, {"count": 0, "total_ms": 0.0})
            s["count"] += 1
            s["total_ms"] += (b - a) / 1e6
        for s in spans.values():
            s["mean_ms"] = s["total_ms"] / s["count"]
        for name, _, n in self.counters:
            c = counters.setdefault(name, {"count": 0, "total": 0.0})
            c["count"] += 1
            c["total"] += n
        for c in counters.values():
            c["mean"] = c["total"] / c["count"]
        return {"spans": spans, "counters": counters}

    def export(self, path: str) -> None:
        """The spans, counters and graphs as one JSON file at ``path``."""
        read_device_times()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"pid": os.getpid(), "clock": "time.perf_counter_ns",
                       "span_fields": SPAN_FIELDS, "spans": self.spans,
                       "counter_fields": COUNTER_FIELDS, "counters": self.counters,
                       "graphs": self.graphs, "summary": self.summary()}, f)


RECORDER = Recorder()


class _Off:
    """What :func:`span` gives when recording is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One span (see :func:`span`); ``seconds`` once it has ended."""

    __slots__ = ("name", "id", "start", "seq", "parent", "rf", "seconds")

    def __init__(self, name: str, id_):
        self.name = name
        self.id = id_
        self.rf = None
        self.seconds = 0.0

    def __enter__(self):
        st = RECORDER.stack()
        self.parent = st[-1].seq if st else None
        self.seq = next(RECORDER.seq)
        st.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        RECORDER.stack().pop()
        self.seconds = (end - self.start) / 1e9
        RECORDER.spans.append((self.name, self.start, end, self.seq, self.parent, self.id,
                               threading.current_thread().name))
        return False


def recording() -> bool:
    """Whether spans and counters record now (a profiler is active, or
    ``TPUST_SPANS=1``)."""
    return RECORDER.env or _autograd_profiler._is_profiler_enabled


def span(name: str, step=None, batch=None, always: bool = False):
    """A span of the enclosed block, as ``with span(...)``: recorded when
    :func:`recording` (or ``always``), else a shared object that does
    nothing. Its id is ``step`` (a step's or a graph branch's), else
    ``batch``; it can be set on the span before the block ends."""
    if always or RECORDER.env or _autograd_profiler._is_profiler_enabled:
        return Span(name, step if step is not None else batch)
    return _OFF


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (an event stamped now), when
    recording."""
    if RECORDER.env or _autograd_profiler._is_profiler_enabled:
        RECORDER.counters.append((name, time.perf_counter_ns(), n))


def count_step(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` for work a CUDA graph may capture:
    while a :class:`~..train.graphs.GraphedStep` captures, the count is kept
    with its graph and added again at each replay (``train/graphs.py``);
    otherwise as :func:`count`."""
    if RECORDER.step_counts is not None:
        RECORDER.step_counts.append((name, n))
    else:
        count(name, n)


def next_batch_id() -> int:
    """A process-wide batch id, for the spans of one batch on two threads."""
    return next(RECORDER.batch_ids)


def device_mark():
    """A timing CUDA event recorded now on the current stream (for a timed
    replay: :func:`device_step`)."""
    ev = RECORDER.spare_events.pop() if RECORDER.spare_events else torch.cuda.Event(
        enable_timing=True)
    ev.record()
    return ev


def device_step(start, t_ns: int) -> None:
    """End the device timing of a replayed call begun with
    :func:`device_mark`; ``t_ns``: the call's host start. Reads the pairs
    already done."""
    RECORDER.pending.append((start, device_mark(), t_ns))
    read_device_times()


def read_device_times() -> None:
    """The ``step.device_ms`` and ``step.gap_ms`` counters of the timed
    replays whose end the device has reached, oldest first, without waiting
    for the others."""
    rec = RECORDER
    while rec.pending and rec.pending[0][1].query():
        start, end, t_ns = rec.pending.popleft()
        rec.counters.append(("step.device_ms", t_ns, start.elapsed_time(end)))
        if rec.last_end is not None:
            rec.counters.append(("step.gap_ms", t_ns, rec.last_end.elapsed_time(start)))
            rec.spare_events.append(rec.last_end)
        rec.spare_events.append(start)
        rec.last_end = end


@functools.cache
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t))
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def graph_nodes(graph) -> int | None:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True`` (libcuda's ``cuGraphGetNodes``); None where libcuda
    does not load or the call fails."""
    try:
        lib = _libcuda()
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n)) != 0:
        return None
    return n.value


def record_graph(step: str, key, first_call_s: float, capture_s: float, nodes) -> int:
    """Keep one captured branch (always); returns its index in
    ``RECORDER.graphs``, the id its replays' spans carry."""
    RECORDER.graphs.append({"step": step, "key": repr(key), "first_call_s": first_call_s,
                            "capture_s": capture_s, "nodes": nodes})
    return len(RECORDER.graphs) - 1


class _Nvml:
    """``libnvidia-ml.so.1`` through ctypes: the card's current SM clock."""

    def __init__(self):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self.lib.nvmlInit_v2.restype = ctypes.c_int
        self.lib.nvmlDeviceGetHandleByPciBusId_v2.argtypes = (ctypes.c_char_p,
                                                              ctypes.POINTER(ctypes.c_void_p))
        self.lib.nvmlDeviceGetHandleByPciBusId_v2.restype = ctypes.c_int
        self.lib.nvmlDeviceGetHandleByIndex_v2.argtypes = (ctypes.c_uint,
                                                           ctypes.POINTER(ctypes.c_void_p))
        self.lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
        self.lib.nvmlDeviceGetClockInfo.argtypes = (ctypes.c_void_p, ctypes.c_int,
                                                    ctypes.POINTER(ctypes.c_uint))
        self.lib.nvmlDeviceGetClockInfo.restype = ctypes.c_int
        if self.lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit failed")
        self.handles: dict[int, ctypes.c_void_p] = {}

    def handle(self, index: int) -> ctypes.c_void_p:
        h = self.handles.get(index)
        if h is None:
            h = ctypes.c_void_p()
            props = torch.cuda.get_device_properties(index)
            bus = getattr(props, "pci_bus_id", None)
            err = 1
            if bus is not None:  # NVML's order need not be CUDA's
                pci = (f"{getattr(props, 'pci_domain_id', 0):08x}:{bus:02x}:"
                       f"{getattr(props, 'pci_device_id', 0):02x}.0")
                err = self.lib.nvmlDeviceGetHandleByPciBusId_v2(pci.encode(), ctypes.byref(h))
            if err != 0 and self.lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(h)) != 0:
                raise OSError(f"no NVML handle for cuda:{index}")
            self.handles[index] = h
        return h

    def sm_clock(self, index: int) -> int:
        mhz = ctypes.c_uint(0)
        err = self.lib.nvmlDeviceGetClockInfo(self.handle(index), NVML_CLOCK_SM,
                                              ctypes.byref(mhz))
        if err != 0:
            raise OSError(f"nvmlDeviceGetClockInfo: {err}")
        return mhz.value


@functools.cache
def _nvml() -> _Nvml | None:
    try:
        return _Nvml()
    except (OSError, AttributeError):  # no library, or one without these calls
        return None


def sm_clock_mhz(device) -> int | None:
    """The card's SM clock now, in MHz (NVML), kept as ``RECORDER.sm_clock``
    and counted as ``sm_clock_mhz`` when recording; None off the card or
    without NVML."""
    device = torch.device(device)
    nvml = _nvml() if device.type == "cuda" else None
    if nvml is None:
        return None
    try:
        mhz = nvml.sm_clock(torch.cuda.current_device() if device.index is None
                            else device.index)
    except OSError:
        return None
    RECORDER.sm_clock = mhz
    count("sm_clock_mhz", mhz)
    return mhz


def _export_at_exit() -> None:
    path = os.path.join(os.environ.get("TPUST_TRACE_DIR", "log/trace"),
                        f"spans-{os.getpid()}.json")
    RECORDER.export(path)
    print(json.dumps(RECORDER.summary()), file=sys.stderr, flush=True)


if RECORDER.env:
    atexit.register(_export_at_exit)


class StepTimer:
    """Per-step wall times on the host clock (a ``with`` block each), with
    p50/p95/mean summaries. A device step is timed only if the block ends
    in a synchronisation."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "p50_ms": ts[n // 2] * 1e3,
            "p95_ms": ts[min(int(n * 0.95), n - 1)] * 1e3,
            "mean_ms": sum(ts) / n * 1e3,
        }


def report_launches(command: str, seconds: float, rank: int = 0) -> None:
    """Print ``{"kernel_launches": ...}`` for this process to stderr when
    ``TPUST_KERNEL_COUNTS=1``; nothing otherwise."""
    if os.environ.get("TPUST_KERNEL_COUNTS", "0") != "1":
        return
    from ..kernels.decode_step import fused_decode_logits
    from ..kernels.lstm_cell import lstm_cell_bwd, lstm_cell_fwd
    from ..kernels.sinkhorn import sinkhorn_cuda
    from ..models.moe import grouped_swiglu

    print(json.dumps({"kernel_launches": {
        "rank": rank, "command": command, "seconds": seconds,
        "fused_decode_logits": fused_decode_logits.launches,
        "sinkhorn": sinkhorn_cuda.launches,
        "lstm_cell_fwd": lstm_cell_fwd.launches,
        "lstm_cell_bwd": lstm_cell_bwd.launches,
        "grouped_swiglu": grouped_swiglu.launches}}), file=sys.stderr, flush=True)
