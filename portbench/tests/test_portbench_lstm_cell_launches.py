"""The reader of ``lstm_cell_launches.optimize``
(``metrics/lstm_cell_launches.optimize.py``) on synthetic recorders: the
fused LSTM cell's launch counters that the optimize step's replays add
inside their ``step.replay`` spans in the traced part of the window, a
replay; nothing where the port records no such counter (the commits before
the kernel) or nothing at all."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench.lib import program
from portbench.lib.manifest import Manifest
from portbench.lib.trace import DeviceTrace

NAME = "lstm_cell_launches.optimize"


def read(r):
    return Manifest(ROOT).reader(NAME).read(r)


def sp(a, b, id_):
    return ("step.replay", round(a * 1e9), round(b * 1e9), 0, None, id_, "MainThread")


def ct(name, t, n):
    return (name, round(t * 1e9), n)


GRAPHS = [{"step": "optimize.fused_step", "key": "True", "first_call_s": 1.0, "capture_s": 0.5,
           "nodes": 8400},
          {"step": "optimize.fused_step", "key": "False", "first_call_s": 1.0, "capture_s": 0.5,
           "nodes": 8300},
          {"step": "optimize.val_step", "key": "None", "first_call_s": 0.1, "capture_s": 0.1,
           "nodes": 900}]


@pytest.fixture
def fake(monkeypatch):
    rec = SimpleNamespace(spans=[], counters=[], graphs=list(GRAPHS))
    monkeypatch.setattr(program, "recorder", lambda: rec)
    return rec


def test_declared_for_the_optimize_cell():
    m = Manifest(ROOT)
    entry = m.per_layer[NAME]
    assert entry["workloads"] == ["yelp.optimize"]
    assert entry["moves"] == "optimize_sent_per_s" and entry["layer"] == "models on the card"
    assert NAME in {x["name"] for x in m.per_layer_of("yelp.optimize")}
    assert NAME not in {x["name"] for x in m.per_layer_of("book.pretrain")}


def test_nothing_without_a_recorder_or_its_counters(monkeypatch, fake):
    r = {"trace": DeviceTrace([], 1.0, 2.0), "trace_steps": 2}
    fake.spans = [sp(1.1, 1.2, 0), sp(1.3, 1.4, 1)]
    assert read(r) is None  # replays, but no kernel counters: a port without the kernel
    monkeypatch.setattr(program, "recorder", lambda: None)
    assert read(r) is None


def test_counts_the_fused_replays_launches_a_step(fake):
    fake.spans = [sp(0.5, 0.6, 0),  # before the trace
                  sp(1.1, 1.2, 0), sp(1.3, 1.4, 1), sp(1.5, 1.6, 2)]  # the last: validation
    fake.counters = [ct("kernel.lstm_cell_fwd", 0.55, 162), ct("kernel.lstm_cell_bwd", 0.55, 108),
                     ct("kernel.lstm_cell_fwd", 1.15, 162), ct("kernel.lstm_cell_bwd", 1.15, 108),
                     ct("kernel.lstm_cell_fwd", 1.35, 162), ct("kernel.lstm_cell_bwd", 1.35, 108),
                     ct("kernel.lstm_cell_eager", 1.35, 3),  # not the fused kernels
                     ct("kernel.lstm_cell_fwd", 1.55, 54)]  # inside the validation's replay
    r = {"trace": DeviceTrace([], 1.0, 2.0), "trace_steps": 2}
    assert read(r) == pytest.approx(270.0)
