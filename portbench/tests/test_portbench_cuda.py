"""On the card: each cell's driver runs for a few seconds and prints a
result line with the contract's keys, correct; and the control (the
reference in the precision below the configuration's, put in the program's
place) fails at least one of the cell's checks at the cell's own size.
Run on the GPU machine: ``python -m pytest -m cuda portbench/tests``."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench.lib.manifest import Manifest

CELLS = sorted(Manifest(ROOT).cells)


def run_card(workload: str, trace: int = 0, control: int = 0, seconds: float = 3.0,
             seed: int = 2600000001):
    from portbench import run

    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace), "--control", str(control)])
    return run.execute(args, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_line(card, workload, trace):
    out = run_card(workload, trace)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    m = Manifest(ROOT)
    want = m.per_layer_of(workload) if trace else m.end_to_end_of(workload)
    assert set(out["metrics"]) <= {x["name"] for x in want}
    if not trace:
        assert set(out["metrics"]) == {x["name"] for x in want}
    else:
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2600000001, 2600000002, 2600000003])
def test_control_fails_a_check(card, workload, seed):
    """The control, put in the program's place, fails one of the cell's
    compared numbers by the harness's own comparison, on every seed."""
    out = run_card(workload, control=1, seed=seed)
    assert out["correct"], out["checks"]
    assert out["control"]["control"]["fails"], out["control"]["control"]
