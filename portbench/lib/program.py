"""What the port records about itself, for the per-layer readers: the spans,
counters and captured graphs of its recorder
(``consistent__style_transfer_torch/utils/profiling.py::RECORDER``).

The recorder stamps its spans and counters on ``time.perf_counter_ns``, the
clock the device trace is moved onto (``lib/trace.py``), and records while a
``torch.profiler`` is active: in a ``--trace 1`` run, the traced part of
the window. The helpers keep what starts inside that part. A port without
the recorder (the commits before it) gives None everywhere, and its
readers report nothing.
"""

from __future__ import annotations

# the optimize stage's train step (``train/optimize.py::GraphedFusedStep.NAME``)
FUSED_STEP = "optimize.fused_step"


def recorder():
    """The port's recorder, or None where the port has none."""
    try:
        from consistent__style_transfer_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def spans(r, *names, thread=None):
    """[(start s, end s, id)] of the recorder's spans called any of
    ``names`` (on the thread called ``thread``, if given) that start in the
    traced part of the window; None without a trace or a recorder."""
    rec, trace = recorder(), r.get("trace")
    if rec is None or trace is None:
        return None
    out = []
    for name, a, b, _, _, id_, th in list(rec.spans):
        if name in names and (thread is None or th == thread) and trace.t0 <= a / 1e9 < trace.t1:
            out.append((a / 1e9, b / 1e9, id_))
    return out


def counted(r, name):
    """The sum of the counter ``name``'s events in the traced part of the
    window; None without a trace or a recorder."""
    rec, trace = recorder(), r.get("trace")
    if rec is None or trace is None:
        return None
    return sum(n for c, t, n in list(rec.counters) if c == name and trace.t0 <= t / 1e9 < trace.t1)


def graphs():
    """The recorder's captured branches (step name, key, first call and
    capture seconds, nodes), or None where there are none."""
    rec = recorder()
    return (rec.graphs or None) if rec is not None else None


def mean_ms(r, name, thread=None):
    """The mean duration, in ms, of the spans ``name`` in the traced part
    of the window; None where there are none."""
    found = spans(r, name, thread=thread)
    if not found:
        return None
    return sum(e - s for s, e, _ in found) / len(found) * 1e3


def fused_replays(r):
    """The ``step.replay`` spans of the optimize stage's fused step in the
    traced part of the window (their id: the branch's index in the
    recorder's graphs), and those graphs; (None, None) where there are
    none."""
    found, kept = spans(r, "step.replay"), graphs()
    if not found or kept is None:
        return None, None
    mine = [sp for sp in found if kept[sp[2]]["step"] == FUSED_STEP]
    return (mine or None), kept


def replay_ms(r):
    """Host ms of the optimize fused step's replay call (the launch of its
    graph and the launch counts), as a mean over the traced replays."""
    mine, _ = fused_replays(r)
    if mine is None:
        return None
    return sum(e - s for s, e, _ in mine) / len(mine) * 1e3


def launch_idle_ms(r):
    """Device idle ms a traced step inside the graphed steps' calls: the
    ``step.copy_in`` and ``step.replay`` spans less the part of each that
    the device's union of intervals covers (overlapping kernels count
    once), summed over the traced part and divided by its steps."""
    found, trace, n = spans(r, "step.copy_in", "step.replay"), r.get("trace"), r.get("trace_steps")
    if not found or not n:
        return None
    idle = sum((e - s) - trace.busy_between(s, e) for s, e, _ in found)
    return idle / n * 1e3


def graph_nodes(r):
    """Graph nodes the optimize fused step replays a step: each branch's
    node count, weighted by its replays in the traced part of the window."""
    mine, kept = fused_replays(r)
    if mine is None or any(kept[i]["nodes"] is None for _, _, i in mine):
        return None
    return sum(kept[i]["nodes"] for _, _, i in mine) / len(mine)


def capture_s(r):
    """Host seconds of the process in the graphed steps' eager first calls
    and captures, every graph of every step."""
    kept = graphs()
    if kept is None:
        return None
    return sum(g["first_call_s"] + g["capture_s"] for g in kept)


def collate_ms(r):
    """Host ms of a batch's ``next`` on the prefetcher's thread (the batch
    and its collate: noise draws, WMD labels), as a mean over the traced
    part of the window."""
    return mean_ms(r, "data.collate", thread="prefetch")


def wmd_label_host_ms(r):
    """Host ms of the WMD labeler a batch (histograms, ground cost, the
    Sinkhorn's launch), as a mean over the traced part of the window."""
    return mean_ms(r, "data.wmd_label")


def prefetch_ready_pct(r):
    """Share of the consumer's takes in the traced part of the window that
    found a batch already queued: 100 * ``data.ready`` / ``data.takes``."""
    takes, ready = counted(r, "data.takes"), counted(r, "data.ready")
    if not takes:
        return None
    return 100.0 * ready / takes
