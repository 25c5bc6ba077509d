"""Profiling hooks: the port of the JAX package's ``utils/profiling.py``. A
``torch.profiler`` trace of any block (host and, on the card, device
activity), written as a Chrome trace that Perfetto or ``chrome://tracing``
opens, and a step-time summary.

``trace`` is on when ``TPUST_TRACE=1`` (or ``enabled=True``), off otherwise,
and then costs nothing; the trace goes to ``log_dir``, else
``$TPUST_TRACE_DIR``, else ``log/trace``. The CLI wraps every command in it.

``report_launches`` (on when ``TPUST_KERNEL_COUNTS=1``) prints, after a CLI
command, one JSON line to stderr with the rank, the command's seconds and
the launch counts of the port's kernels in this process: a process started
by the launcher counts its own launches, which no caller can read
otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch


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
    from ..kernels.sinkhorn import sinkhorn_cuda

    print(json.dumps({"kernel_launches": {
        "rank": rank, "command": command, "seconds": seconds,
        "fused_decode_logits": fused_decode_logits.launches,
        "sinkhorn": sinkhorn_cuda.launches}}), file=sys.stderr, flush=True)
