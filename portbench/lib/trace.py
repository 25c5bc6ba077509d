"""The device trace of a traced window, reduced to intervals on the host's
clock, and the arithmetic every per-layer reader shares.

Busy time is the union of the device's intervals (kernels, copies, memsets):
kernels that overlap, as the decode head's two do under programmatic
dependent launch, count once. Summing their durations instead counts the
overlap twice, which once gave negative idle shares.

The profiler stamps its events on its own clock. A marker recorded at the
start of the traced window, beside a read of ``time.perf_counter``, gives
the offset to the host's clock, on which the harness keeps its spans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MARKER = "portbench.clock"


def union(intervals):
    """Merge (start, end) pairs into disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, a: float, b: float) -> float:
    """Seconds of [a, b] that the disjoint intervals ``merged`` cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def gaps(merged, a: float, b: float):
    """The idle (start, end) gaps of [a, b] between the disjoint intervals."""
    out, t = [], a
    for s, e in merged:
        if e <= a or s >= b:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


@dataclass
class DeviceTrace:
    """Device intervals (start s, end s, name) on the host's
    ``perf_counter`` clock, over the traced window [t0, t1]."""

    events: list
    t0: float
    t1: float
    merged: list = field(default_factory=list)

    def __post_init__(self):
        self.merged = union((s, e) for s, e, _ in self.events)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return covered(self.merged, self.t0, self.t1)

    def busy_between(self, a: float, b: float) -> float:
        return covered(self.merged, a, b)

    def named(self, *fragments: str):
        """Events whose name holds any of ``fragments``."""
        return [ev for ev in self.events if any(f in ev[2] for f in fragments)]

    def top_ops(self, n: int = 10):
        """[(name, seconds)] of the device operations that took most time."""
        by = {}
        for s, e, name in self.events:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k[:120], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, spans, n: int = 10):
        """[(what the host was doing, seconds)] of the longest idle gaps:
        the host span (name, start, end) that holds the gap's midpoint, the
        innermost one where spans nest."""
        out = []
        for a, b in gaps(self.merged, self.t0, self.t1):
            mid = (a + b) / 2
            inside = [(e - s, name) for name, s, e in spans if s <= mid <= e]
            out.append([min(inside)[1] if inside else "host", b - a])
        return sorted(out, key=lambda kv: -kv[1])[:n]


class Tracer:
    """``torch.profiler`` around a part of the window: :meth:`start` and
    :meth:`stop` on one thread; :meth:`stop` synchronises the device first,
    so the window ends when its last operation has."""

    def __init__(self):
        self.prof = None
        self.host0 = 0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function(MARKER):
            self.host0 = time.perf_counter_ns()
        self.t0 = self.host0 / 1e9

    def stop(self) -> DeviceTrace:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        return self.reduce()

    def reduce(self) -> DeviceTrace:
        from torch.autograd import DeviceType

        raw = self.prof.profiler.kineto_results.events()
        offset = None
        events = []
        for ev in raw:
            if ev.name() == MARKER and ev.device_type() == DeviceType.CPU:
                offset = ev.start_ns() - self.host0
            elif ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
                events.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
        if offset is None:
            raise RuntimeError(f"the trace holds no {MARKER} marker")
        return DeviceTrace([((s - offset) / 1e9, (e - offset) / 1e9, name)
                            for s, e, name in events], self.t0, self.t1)
