"""`lstm_cell_launches.optimize`: launches of the fused LSTM cell's forward
and backward kernels (``csrc/lstm_cell.cu``) a traced optimize step. Each
replay of the optimize stage's fused step adds its graph's captured launches
to the port's counters ``kernel.lstm_cell_fwd`` and ``kernel.lstm_cell_bwd``
inside its ``step.replay`` span; this sums those found inside the traced
replays' spans and divides by the replays. A port without the kernel (or
without the counters) gives None."""

from portbench.lib.program import fused_replays, recorder

COUNTERS = ("kernel.lstm_cell_fwd", "kernel.lstm_cell_bwd")


def read(r):
    mine, _ = fused_replays(r)
    rec = recorder()
    if mine is None or rec is None:
        return None
    n = sum(v for name, t, v in list(rec.counters)
            if name in COUNTERS and any(s <= t / 1e9 <= e for s, e, _ in mine))
    return n / len(mine) if n else None
