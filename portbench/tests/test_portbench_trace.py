"""The metric arithmetic on synthetic traces: the union of overlapping
device intervals, busy and idle time, a kernel's time per call over the
calls found, and the window's readings a stall must move."""

from __future__ import annotations

import pytest

from portbench.lib.manifest import Manifest
from portbench.lib.trace import DeviceTrace, covered, gaps, union
from conftest import ROOT


def reader(name):
    return Manifest(ROOT).reader(name)


def test_union_counts_overlapping_kernels_once():
    merged = union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)])
    assert merged == [(0.0, 3.0), (5.0, 6.0)]
    assert covered(merged, 0.0, 10.0) == pytest.approx(4.0)
    assert covered(merged, 2.5, 5.5) == pytest.approx(1.0)
    assert gaps(merged, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_idle_and_device_per_step_from_the_union():
    # two kernels overlapping by half: summed durations would read 6 s busy of 5
    trace = DeviceTrace([(0.0, 3.0, "a"), (1.5, 4.5, "b")], 0.0, 5.0)
    assert trace.busy_s == pytest.approx(4.5)
    r = {"trace": trace, "trace_steps": 3}
    assert reader("idle_pct.optimize").read(r) == pytest.approx(10.0)
    assert reader("device_ms_per_step.pretrain").read(r) == pytest.approx(1500.0)
    assert trace.idle_gaps([("data_wait", 4.4, 5.0)])[0] == ["data_wait", pytest.approx(0.5)]


def test_kernel_time_per_call_over_the_calls_found():
    """The Sinkhorn's share of its roofline divides its busy time by the
    calls the trace holds: the tracer may drop one, and the launch count
    would then read the kernel fast."""
    from portbench.counts.roofline import sinkhorn_bound

    atoms = [([3, 4], [5, 2]), ([3, 4], [5, 2])]
    ev = [(0.0, 30e-6, "sinkhorn_kernel"), (1e-3, 1e-3 + 30e-6, "sinkhorn_kernel"),
          (2e-3, 3e-3, "elementwise")]  # a third call was dropped
    r = {"trace": DeviceTrace(ev, 0.0, 4e-3), "sinkhorn_atoms": atoms,
         "sinkhorn_padded": (45, 45)}
    got = reader("sinkhorn_roofline").read(r)
    assert got == pytest.approx(100 * sinkhorn_bound([3, 4], [5, 2], 45, 45)["bound_ms"] / 0.03)
    assert reader("sinkhorn_roofline").read({**r, "trace": DeviceTrace([], 0, 1)}) is None


def test_a_stall_moves_the_window_readings():
    """The window's readings are over all its steps and all its time: a
    stall inside it lowers the whole step's share of the peak and shows in
    the wait for data."""
    mfu = reader("mfu.optimize")
    r = {"steps": 100, "window_s": 5.0, "step_flops": 1e12, "val_passes": 1, "val_flops": 1e13}
    stalled = {**r, "window_s": 6.0}
    assert mfu.read(stalled) == pytest.approx(mfu.read(r) * 5.0 / 6.0)
    spans = [("data_wait", 1.0 + i * 0.05, 1.0 + i * 0.05 + 0.001) for i in range(100)]
    wait = reader("data_wait_ms.optimize")
    base = wait.read({"spans": spans, "window": (1.0, 7.0), "steps": 100})
    spans[50] = ("data_wait", 3.5, 4.5)
    assert wait.read({"spans": spans, "window": (1.0, 7.0), "steps": 100}) > 10 * base


def test_span_means_read_only_the_window():
    spans = [("data_wait", 0.5, 0.6), ("data_wait", 1.0, 1.002), ("data_wait", 1.5, 1.504),
             ("dispatch", 1.1, 1.101), ("dispatch", 1.6, 1.603)]
    r = {"spans": spans, "window": (1.0, 2.0), "steps": 2}
    assert reader("data_wait_ms.optimize").read(r) == pytest.approx(3.0)
    assert reader("dispatch_ms.pretrain").read(r) == pytest.approx(2.0)
