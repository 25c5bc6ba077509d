"""The readers of the port's own spans, counters and graphs
(``lib/program.py``): on synthetic recorders and device traces, what each
reads inside the traced part of the window, and nothing where the port
recorded nothing. On the card (``cuda``): a captured branch's node count
is libcuda's for that graph, the CUDA-event device time of each replay is
the device trace's, and in a traced optimize run each step's graph starts
on the device while or just after its ``step.replay`` span runs, on the
clock the spans and the trace share."""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench.lib import program
from portbench.lib.manifest import Manifest
from portbench.lib.trace import DeviceTrace

NEW = ("replay_ms.optimize", "launch_idle_ms.optimize", "graph_nodes.optimize",
       "capture_s.optimize", "capture_s.pretrain", "collate_ms.pretrain",
       "wmd_label_host_ms.pretrain", "prefetch_ready_pct.pretrain")


def reader(name):
    return Manifest(ROOT).reader(name)


def ns(s: float) -> int:
    return round(s * 1e9)


def sp(name, a, b, id_=None, thread="MainThread"):
    """A recorder span from seconds."""
    return (name, ns(a), ns(b), 0, None, id_, thread)


@pytest.fixture
def fake(monkeypatch):
    """A recorder of synthetic spans, counters and graphs in the readers'
    place."""
    rec = SimpleNamespace(spans=[], counters=[], graphs=[])
    monkeypatch.setattr(program, "recorder", lambda: rec)
    return rec


def test_the_new_metrics_are_declared_for_their_cells():
    m = Manifest(ROOT)
    for name in NEW:
        cell = "yelp.optimize" if name.endswith(".optimize") else "book.pretrain"
        assert m.per_layer[name]["workloads"] == [cell]
        assert name in {x["name"] for x in m.per_layer_of(cell)}


@pytest.mark.parametrize("name", NEW)
def test_readers_report_nothing_without_a_recorder(monkeypatch, name):
    """A port without the recorder (the parent commit's), or a run with no
    trace, gives None and raises nothing."""
    monkeypatch.setattr(program, "recorder", lambda: None)
    r = {"trace": DeviceTrace([], 0.0, 1.0), "trace_steps": 4}
    assert reader(name).read(r) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_report_nothing_from_an_empty_recorder(fake, name):
    assert reader(name).read({"trace": DeviceTrace([], 0.0, 1.0), "trace_steps": 4}) is None


def test_fused_replays_count_their_branch_nodes_inside_the_trace(fake):
    fake.graphs = [{"step": "optimize.fused_step", "key": "True", "first_call_s": 1.5,
                    "capture_s": 0.5, "nodes": 12000, },
                   {"step": "optimize.fused_step", "key": "False", "first_call_s": 1.0,
                    "capture_s": 0.25, "nodes": 11000},
                   {"step": "optimize.val_step", "key": "None", "first_call_s": 0.2,
                    "capture_s": 0.05, "nodes": 900}]
    fake.spans = [sp("step.replay", 0.5, 0.51, 0),  # before the trace
                  sp("step.replay", 1.0, 1.002, 0), sp("step.replay", 1.1, 1.104, 1),
                  sp("step.replay", 1.2, 1.202, 1), sp("step.replay", 1.3, 1.301, 1),
                  sp("step.replay", 1.4, 1.5, 2)]  # validation: not the fused step
    r = {"trace": DeviceTrace([], 1.0, 2.0), "trace_steps": 4}
    assert reader("replay_ms.optimize").read(r) == pytest.approx(2.25)
    assert reader("graph_nodes.optimize").read(r) == pytest.approx((12000 + 3 * 11000) / 4)
    for cell in ("optimize", "pretrain"):
        assert reader(f"capture_s.{cell}").read(r) == pytest.approx(3.5)
    fake.graphs[1]["nodes"] = None  # libcuda did not count it
    assert reader("graph_nodes.optimize").read(r) is None


def test_launch_idle_counts_overlapping_kernels_once(fake):
    """Idle inside the copy and replay spans is the span less the union of
    the device's intervals: two kernels overlapping inside a replay leave
    the same idle as one kernel over their union."""
    fake.spans = [sp("step.copy_in", 1.0, 1.1), sp("step.replay", 1.1, 1.5, 0),
                  sp("step.copy_in", 2.0, 2.1), sp("step.replay", 2.1, 2.5, 0),
                  sp("step.replay", 0.2, 0.4, 0)]  # before the trace
    events = [(1.2, 1.4, "a"), (1.3, 1.45, "b"),  # union 1.2-1.45
              (2.05, 2.3, "c")]
    r = {"trace": DeviceTrace(events, 1.0, 3.0), "trace_steps": 2}
    idle = (0.5 - 0.25) + (0.5 - 0.25)
    assert reader("launch_idle_ms.optimize").read(r) == pytest.approx(idle / 2 * 1e3)
    one = {"trace": DeviceTrace([(1.2, 1.45, "a"), (2.05, 2.3, "c")], 1.0, 3.0), "trace_steps": 2}
    assert reader("launch_idle_ms.optimize").read(one) == pytest.approx(idle / 2 * 1e3)


def test_data_readers_take_the_traced_part_and_the_prefetch_thread(fake):
    fake.spans = [sp("data.collate", 1.0, 1.010, 0, "prefetch"),
                  sp("data.collate", 1.02, 1.040, 1, "prefetch"),
                  sp("data.collate", 1.05, 1.150, None, "MainThread"),  # a validation's
                  sp("data.collate", 0.5, 0.9, 7, "prefetch"),  # before the trace
                  sp("data.wmd_label", 1.001, 1.005, None, "prefetch"),
                  sp("data.wmd_label", 1.021, 1.027, None, "prefetch")]
    fake.counters = [("data.takes", ns(0.5), 1), ("data.ready", ns(0.5), 1),
                     ("data.takes", ns(1.1), 1), ("data.takes", ns(1.2), 1),
                     ("data.ready", ns(1.2), 1), ("data.takes", ns(1.3), 1),
                     ("data.takes", ns(2.5), 1), ("data.ready", ns(2.5), 1)]  # after it
    r = {"trace": DeviceTrace([], 1.0, 2.0), "trace_steps": 3}
    assert reader("collate_ms.pretrain").read(r) == pytest.approx(15.0)
    assert reader("wmd_label_host_ms.pretrain").read(r) == pytest.approx(5.0)
    assert reader("prefetch_ready_pct.pretrain").read(r) == pytest.approx(100 / 3)


# ---- on the card


def nodes_by_libcuda(graph) -> int:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t))
    lib.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n)) == 0
    return n.value


@pytest.mark.cuda
def test_graph_nodes_and_device_times_on_the_card(card, monkeypatch):
    """A GraphedStep's branch keeps libcuda's node count of its graph, and
    each replay's CUDA-event device time is the device trace's time of that
    step within 10%: from its first operation's start to its last one's
    end. (The profiler drops a record now and then, often one a step here;
    a union of the step's intervals would then read a kernel short, while
    the kernels of a step run back to back.)"""
    import torch

    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.utils import profiling
    from portbench.lib.trace import Tracer

    monkeypatch.setattr(profiling.RECORDER, "env", False)
    w = torch.randn(4096, 4096, device=card)

    def fn(inputs, key):
        y = inputs["x"]
        for _ in range(8):
            y = torch.tanh(y @ w)
        return y

    step = GraphedStep(fn, name="test.matmuls")
    x = torch.randn(4096, 4096, device=card)
    step({"x": x})
    torch.cuda.synchronize()
    kept = profiling.RECORDER.graphs[step.branches[None]]
    assert kept["step"] == "test.matmuls" and kept["capture_s"] > 0 and kept["first_call_s"] > 0
    assert kept["nodes"] == nodes_by_libcuda(step.graphs[None]) >= 16
    profiling.RECORDER.clear()
    tracer = Tracer()
    tracer.start()
    for _ in range(6):
        step({"x": x})
        torch.cuda.synchronize()
    trace = tracer.stop()
    profiling.read_device_times()
    device = [(t, ms) for name, t, ms in profiling.RECORDER.counters if name == "step.device_ms"]
    assert len(device) == 6
    starts = [t / 1e9 for t, _ in device] + [trace.t1]
    steps = []  # (CUDA-event ms, the trace's first start to last end in ms, records)
    for (_, ms), a, b in zip(device, starts, starts[1:]):
        mine = [(s, e) for s, e, _ in trace.events if a <= s < b]
        steps.append((ms, (max(e for _, e in mine) - min(s for s, _ in mine)) * 1e3, len(mine)))
    assert all(abs(ms - seen) <= 0.1 * seen for ms, seen, _ in steps), steps


def clock_offsets(seed: int = 2600000003) -> dict:
    """A traced optimize run in this process: for each traced step, the
    first kernel of its graph less its ``step.replay`` span's start, and
    less its end (seconds). Each step follows a sync, so every kernel that
    starts after the step's ``step.copy_in`` span began is the step's: its
    copies (``Memcpy``) and then its graph's kernels."""
    from consistent__style_transfer_torch.utils import profiling
    from portbench import run
    from portbench.lib import trace as trace_lib

    traces = []
    real_stop = trace_lib.Tracer.stop

    def keep(self):
        traces.append(real_stop(self))
        return traces[-1]

    trace_lib.Tracer.stop = keep
    try:
        out = run.execute(run.parse(["--workload", "yelp.optimize", "--seed", str(seed),
                                     "--seconds", "3", "--trace", "1"]), "cuda")
    finally:
        trace_lib.Tracer.stop = real_stop
    trace, = traces
    spans = sorted((s for s in profiling.RECORDER.spans if trace.t0 <= s[1] / 1e9 < trace.t1
                    and s[0] in ("step.copy_in", "step.replay")), key=lambda s: s[1])
    offsets = []
    for i in range(1, len(spans)):
        (kind, a, b, *_), copy = spans[i], spans[i - 1]
        if kind != "step.replay" or copy[0] != "step.copy_in":
            continue
        nxt = spans[i + 1][1] / 1e9 if i + 1 < len(spans) else trace.t1
        first = min(s for s, e, name in trace.events
                    if copy[1] / 1e9 <= s < nxt and "Memcpy" not in name)
        offsets.append((first - a / 1e9, first - b / 1e9))
    return {"correct": out["correct"], "metrics": sorted(out["metrics"]), "offsets": offsets}


@pytest.mark.cuda
def test_replay_spans_share_the_device_clock(card):
    """A traced optimize run, in a process of its own as the benchmark runs
    it: the first kernel of each step's graph starts inside its
    ``step.replay`` span (20-50 ms under the profiler), to within 1 ms on
    either side. The harness moves the profiler's stamps onto
    ``perf_counter`` by one offset read at the trace's start; on the card
    that mapping was off by up to 0.17 ms in a fresh process, and by up to
    0.74 ms in a second profiler session of one process."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys; sys.path[:0] = [{ROOT!r}, {here!r}]; "
            "import test_portbench_program_spans as t; print(json.dumps(t.clock_offsets()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and {n for n in NEW if "optimize" in n} <= set(got["metrics"])
    offsets = got["offsets"]
    assert len(offsets) >= 4
    assert all(after_start >= -1e-3 and after_end <= 1e-3
               for after_start, after_end in offsets), offsets
