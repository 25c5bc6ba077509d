"""The port's spans and counters (``utils/profiling.py``) on the CPU: off,
a prefetcher pass over labelled pretrain batches records nothing; on
(``TPUST_SPANS=1``, or while a ``torch.profiler`` records), the prefetcher
thread's spans are kept with the batch ids of the consumer's takes; parents
nest; the stamps are ``perf_counter`` nanoseconds; ``data.ready`` counts a
queued batch; the device timings' arithmetic; where a count made during a
capture goes; the exit export."""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time

import pytest
import torch

from consistent__style_transfer_torch.data.corpus import StyleCorpus
from consistent__style_transfer_torch.data.pipeline import make_batches
from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher, take
from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
from consistent__style_transfer_torch.text.bpe import BPETokenizer
from consistent__style_transfer_torch.text.word2vec import train_token_w2v
from consistent__style_transfer_torch.train.loop import Throughput, clock_of
from consistent__style_transfer_torch.utils import profiling
from consistent__style_transfer_torch.utils.profiling import RECORDER, count, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def batches(tiny_corpus):
    """The pretrain iterator of the tiny train split (3 batches of 4), its
    WMD labels from the Sinkhorn labeler on the CPU."""
    files = [os.path.join(tiny_corpus, f"style.train.{i}") for i in (0, 1)]
    tok = BPETokenizer.train(files, 120)
    w2v = train_token_w2v(files, tok, epochs=1, seed=1, prefer_native=False, dim=16,
                          min_count=1)
    labeler = SinkhornWmdLabeler(w2v, tok, max_atoms=12, device=CPU)
    corpus = StyleCorpus.from_files(files, tok, max_len=8)
    return make_batches(corpus, 4, 8, "pretrain", shuffle=True, seed=0, wmd_labeler=labeler)


@pytest.fixture
def recorder(monkeypatch):
    """The process's recorder, emptied, with ``TPUST_SPANS`` off."""
    monkeypatch.setattr(RECORDER, "env", False)
    RECORDER.clear()
    yield RECORDER
    RECORDER.clear()


def by_name(rec, name):
    return [s for s in rec.spans if s[0] == name]


def test_spans_off_record_nothing(batches, recorder, monkeypatch):
    calls = []
    real = profiling._autograd_profiler.record_function
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    assert not profiling.recording()
    assert span("x") is span("y", batch=3)  # one shared object: no allocation
    n = sum(1 for _ in DevicePrefetcher(batches, CPU))
    assert n == 3
    assert recorder.spans == [] and recorder.counters == [] and calls == []


@pytest.mark.parametrize("mode", ["env", "profiler"])
def test_prefetcher_spans_carry_the_takes_batch_ids(batches, recorder, monkeypatch, mode):
    """The producer thread's spans are kept (the switch is seen from that
    thread) and each batch's id is the one its take carries."""
    from torch.profiler import ProfilerActivity, profile

    if mode == "env":
        monkeypatch.setattr(RECORDER, "env", True)
        n = sum(1 for _ in DevicePrefetcher(batches, CPU))
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.recording()
            seen = []
            t = threading.Thread(target=lambda: seen.append(profiling.recording()))
            t.start()
            t.join(timeout=10)
            assert seen == [True]
            n = sum(1 for _ in DevicePrefetcher(batches, CPU))
        assert not profiling.recording()
    assert n == 3
    takes = by_name(recorder, "data.take")  # and the take of the end's sentinel, no id
    assert {s[6] for s in takes} == {threading.current_thread().name}
    assert len(takes) == 4 and takes[-1][5] is None
    takes = takes[:3]
    take_ids = [s[5] for s in takes]
    assert None not in take_ids and len(set(take_ids)) == 3
    for name in ("data.h2d", "data.put_wait"):
        got = by_name(recorder, name)
        assert [s[5] for s in got] == take_ids and {s[6] for s in got} == {"prefetch"}
    collates = by_name(recorder, "data.collate")  # one more: the iterator's end
    assert [s[5] for s in collates][:3] == take_ids and len(collates) == 4
    # each batch's noise draws and labels nest in its collate, on its thread
    seq = {s[3]: s for s in recorder.spans}
    for name, per_batch in (("data.noise", 2), ("data.wmd_label", 1)):
        got = by_name(recorder, name)
        assert len(got) == 3 * per_batch
        assert all(seq[s[4]][0] == "data.collate" and s[6] == "prefetch" for s in got)
    # a batch is taken after its put began
    puts = {s[5]: s for s in by_name(recorder, "data.put_wait")}
    assert all(puts[s[5]][1] <= s[2] for s in takes)
    totals = {name: sum(n for c, _, n in recorder.counters if c == name)
              for name in ("data.takes", "data.ready")}
    assert totals["data.takes"] == 3 and 0 <= totals["data.ready"] <= 3


def test_parents_nest(recorder, monkeypatch):
    monkeypatch.setattr(RECORDER, "env", True)

    def elsewhere():
        with span("thread"):
            pass

    with span("outer", step=7):
        with span("inner"):
            with span("leaf", batch=2):
                pass
        with span("sibling"):
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    s = {x[0]: x for x in recorder.spans}
    assert s["outer"][4] is None and s["outer"][5] == 7
    assert s["inner"][4] == s["outer"][3] and s["sibling"][4] == s["outer"][3]
    assert s["leaf"][4] == s["inner"][3] and s["leaf"][5] == 2
    assert s["thread"][4] is None  # another thread's stack is its own


def test_stamps_are_perf_counter_nanoseconds(recorder, monkeypatch):
    monkeypatch.setattr(RECORDER, "env", True)
    a = time.perf_counter_ns()
    with span("s") as sp:
        time.sleep(0.01)
    b = time.perf_counter_ns()
    (_, start, end, *_), = recorder.spans
    assert a <= start < end <= b and end - start >= 10_000_000
    assert sp.seconds == pytest.approx((end - start) / 1e9)
    assert abs(start / 1e9 - time.perf_counter()) < 5.0


def test_always_spans_time_with_recording_off(recorder):
    assert not profiling.recording()
    with span("epoch", step=0, always=True) as ep:
        time.sleep(0.005)
    assert ep.seconds >= 0.005 and [s[0] for s in recorder.spans] == ["epoch"]
    count("c")  # off: nothing
    assert recorder.counters == []


def test_ready_counts_a_queued_batch(recorder, monkeypatch):
    monkeypatch.setattr(RECORDER, "env", True)
    q = queue.Queue()
    q.put((11, "batch", {}))
    assert take(q)[0] == 11  # queued before the take: ready
    timer = threading.Timer(0.05, lambda: q.put((12, "batch", {})))
    timer.start()
    assert take(q)[0] == 12  # the take waited for it: not ready
    timer.join(timeout=10)
    end = object()
    q.put(end)
    assert take(q) is end  # the end's sentinel is no take
    names = [c[0] for c in recorder.counters]
    assert names == ["data.takes", "data.ready", "data.takes"]
    assert [s[5] for s in by_name(recorder, "data.take")] == [11, 12, None]


class FakeEvent:
    """A CUDA event stand-in: done or not, at a time in ms."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_times_read_only_what_is_done(recorder):
    first = (FakeEvent(0.0), FakeEvent(4.0), 100)
    second = (FakeEvent(5.5), FakeEvent(10.0, done=False), 200)
    recorder.pending.extend([first, second])
    profiling.read_device_times()
    assert recorder.counters == [("step.device_ms", 100, 4.0)]
    second[1].done = True
    profiling.read_device_times()
    assert recorder.counters[1:] == [("step.device_ms", 200, 4.5), ("step.gap_ms", 200, 1.5)]
    assert not recorder.pending


def test_a_count_on_another_thread_during_a_capture_counts_at_once(recorder, monkeypatch):
    """While the main thread captures on its stream (7, a ``kept_counts``
    scope), a ``count_step`` on a second thread, on a stream of its own (the
    prefetcher's Sinkhorn), is counted at once: in the total and, when
    recording, as an event, and not in the scope's sums. A count on the
    capturing stream from another thread (the autograd engine's, running a
    captured backward) is kept with the capture; one on a stream captured
    outside any scope (9) counts nothing. The streams are stand-ins: the
    CPU has none."""
    monkeypatch.setattr(recorder, "env", True)
    on = threading.local()
    monkeypatch.setattr(profiling, "capturing_stream", lambda: getattr(on, "stream", None))
    before = {k: profiling.total(f"test.{k}") for k in ("fwd", "bwd", "sinkhorn", "other")}

    def on_thread(stream, name):
        def work():
            on.stream = stream
            profiling.count_step(f"test.{name}", 1)
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    on.stream = 7
    try:
        with profiling.kept_counts(7) as kept:
            profiling.count_step("test.fwd", 1)
            on_thread(None, "sinkhorn")
            on_thread(7, "bwd")
            on_thread(9, "other")
    finally:
        on.stream = None
    assert dict(kept) == {"test.fwd": 1, "test.bwd": 1}
    assert [(n, v) for n, _, v in recorder.counters] == [("test.sinkhorn", 1)]
    assert {k: profiling.total(f"test.{k}") - n for k, n in before.items()} == {
        "fwd": 0, "bwd": 0, "sinkhorn": 1, "other": 0}
    assert 7 not in recorder.kept


def test_totals_lose_no_count_across_threads(recorder):
    """Eight threads counting one name 5,000 times each, switching every
    microsecond, leave a total of 40,000 (the prefetcher's thread and the
    main thread count into the same totals)."""
    before = profiling.total("test.threads")
    interval = sys.getswitchinterval()

    def work():
        for _ in range(5000):
            profiling.count_step("test.threads", 1)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.total("test.threads") - before == 40_000


def test_clock_and_throughput_off_the_card():
    assert profiling.sm_clock_mhz(CPU) is None and clock_of(CPU) == {}
    thru = Throughput()
    thru.add(4)
    assert thru.t0 <= time.perf_counter() and thru.rates()["sentences_per_sec"] > 0


def test_exit_export_writes_valid_json(tmp_path):
    script = ("from consistent__style_transfer_torch.utils.profiling import count, span\n"
              "with span('outer', step=3):\n"
              "    with span('inner', batch=5):\n"
              "        count('c', 2)\n"
              "    count('c', 4)\n")
    env = {**os.environ, "TPUST_SPANS": "1", "TPUST_TRACE_DIR": str(tmp_path / "spans"),
           "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    files = os.listdir(tmp_path / "spans")
    assert len(files) == 1 and files[0].startswith("spans-") and files[0].endswith(".json")
    with open(tmp_path / "spans" / files[0], encoding="utf-8") as f:
        got = json.load(f)
    assert got["clock"] == "time.perf_counter_ns"
    spans = [dict(zip(got["span_fields"], s)) for s in got["spans"]]
    assert [s["name"] for s in spans] == ["inner", "outer"]
    assert spans[0]["parent"] == spans[1]["seq"] and spans[0]["id"] == 5
    assert [c[2] for c in got["counters"]] == [2, 4]
    summary = json.loads(out.stderr.strip().splitlines()[-1])
    assert summary["spans"]["outer"]["count"] == 1
    assert summary["counters"]["c"] == {"count": 2, "total": 6.0, "mean": 3.0}
