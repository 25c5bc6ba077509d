"""``book.optimize``: the optimize driver over the book configuration (L=30,
B=128 at its own size), on the CPU at the tiny sizes, comes out correct
against its limits, and the control's planted faults read above a sound
run."""

from __future__ import annotations

from conftest import run_cpu


def test_book_optimize_sound_run_is_correct(checkout):
    out = run_cpu(checkout, "book.optimize", control=1)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"optimize_sent_per_s", "setup_s"}
    for fault in ("token", "half_batch", "half_loss", "unchanged"):
        assert out["control"][fault]["fails"], fault
