"""The per-layer readers the training cells share: each metric's file
under ``portbench/metrics/`` names the one it reads, so the optimize and the
pretrain cell each have metrics of their own, moving their own rate."""

from portbench.counts.roofline import PEAK_OPS_S


def data_wait_ms(r):
    """Host ms a training step waits for its batch: the harness's span
    around each ``next()`` of the stage's ``DevicePrefetcher`` (the
    batches, the collates and the copies to the device), summed over the
    window and divided by the window's steps."""
    t0, t1 = r["window"]
    waits = [e - s for name, s, e in r["spans"] if name == "data_wait" and t0 <= s < t1]
    if not waits or not r.get("steps"):
        return None
    return sum(waits) / r["steps"] * 1e3


def dispatch_ms(r):
    """Host ms a training step spends in its one dispatch: the harness's
    span around each call of the step's runner (``train/graphs.py``:
    copying the batch into the graph's buffers and launching its replay,
    with no sync inside), as a mean over the window's steps."""
    t0, t1 = r["window"]
    calls = [e - s for name, s, e in r["spans"] if name == "dispatch" and t0 <= s < t1]
    if not calls:
        return None
    return sum(calls) / len(calls) * 1e3


def device_ms_per_step(r):
    """Device ms a training step takes: the union of the device's
    intervals in the traced part of the window over the steps in it."""
    trace, n = r.get("trace"), r.get("trace_steps")
    if trace is None or not n or trace.busy_s <= 0:
        return None
    return trace.busy_s / n * 1e3


def idle_pct(r):
    """Share of the traced part of a training window in which no operation
    ran on the device: 100 * (1 - union of device intervals / traced
    seconds)."""
    trace = r.get("trace")
    if trace is None or r.get("trace_steps") is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(r):
    """The whole training window's share of the chip's dense bf16 peak (989
    TFLOP/s): the benchmark's own count of the window's floating-point work
    (``counts/flops.py``: every step, every validation pass) over the
    window's seconds on the host's clock."""
    if not r.get("steps") or not r.get("window_s"):
        return None
    work = r["steps"] * r["step_flops"] + r["val_passes"] * r["val_flops"]
    return 100.0 * work / r["window_s"] / PEAK_OPS_S["bfloat16"]
