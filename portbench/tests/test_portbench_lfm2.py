"""The LFM2-8B-A1B optimize cell (``yelp-lfm2moe.optimize``) on the CPU at a
tiny width: the routed FLOP count against FlopCounterMode over the plain
reference, the grouped products' roofline bound, the per-layer readers, a
sound run correct with the control and the planted faults reading far
above it, and the program with a planted fault (each token routed to its
top 3 experts; a conv state handed one step late in decode; Adam's steps
twice as long) not correct.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import ROOT, TINY
from portbench.counts import moe as moe_counts
from portbench.counts.roofline import PEAK_BYTES_S, PEAK_OPS_S
from portbench.drivers.optimize_lfm2 import route_tables
from portbench.lib.manifest import Manifest
from portbench.reference import lfm2_moe as ref_lfm2

CELL = "yelp-lfm2moe.optimize"
# the published widths cut for a CPU run; every other key the configuration's
NARROW = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=96, moe_intermediate_size=32, num_experts=8,
              num_hidden_layers=4)
PORT_NARROW = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, d_expert=32,
                   n_experts=8)


def _config(**over):
    cfg = Manifest(ROOT).config(Manifest(ROOT).cell(CELL))
    return {**cfg, **NARROW, **over}


@pytest.fixture
def narrow_port(monkeypatch):
    """The port's published widths cut as NARROW cuts the configuration's."""
    from consistent__style_transfer_torch.models import lfm2_moe

    for key, value in PORT_NARROW.items():
        monkeypatch.setitem(lfm2_moe.PUBLISHED, key, value)


@pytest.fixture(scope="module")
def sound(checkout):
    """A sound run, with the control's and the planted faults' readings."""
    from consistent__style_transfer_torch.models import lfm2_moe

    old = dict(lfm2_moe.PUBLISHED)
    lfm2_moe.PUBLISHED.update(PORT_NARROW)
    try:
        return run_cell(checkout, control=1)
    finally:
        lfm2_moe.PUBLISHED.clear()
        lfm2_moe.PUBLISHED.update(old)


def run_cell(root, control=0, seed=3_000_000_011):
    from portbench import run

    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "1.5", "--trace",
                      "0", "--control", str(control)])
    return run.execute(args, "cpu", root=root, overrides={**TINY, **NARROW})


def test_the_pass_count_is_flopcountermode_over_the_reference():
    """A full pass of the reference over 6 positions, 3 sequences: the
    count of its products, the routed experts at T x k rows."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _config(vocab_size=50)
    torch.manual_seed(0)
    G = ref_lfm2.build(cfg, 50, "cpu")
    G.load_state_dict(ref_lfm2.seeded_state(cfg, 50, 5, "cpu"))
    h = torch.randn(3, 6, cfg["hidden_size"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        G.logits(h)
    assert counter.get_total_flops() == moe_counts.pass_flops(cfg, 3, 6)


def test_the_step_count_takes_k_experts_a_token():
    """Doubling the experts leaves the count as it is; doubling the experts
    a token doubles the experts' part."""
    cfg = _config()
    base = moe_counts.pass_flops(cfg, 4, 5)
    assert moe_counts.pass_flops({**cfg, "num_experts": 16}, 4, 5) - base == \
        4 * 5 * 2 * 64 * 8 * 2  # the router's 8 more outputs, in 2 expert layers
    k2 = moe_counts.pass_flops({**cfg, "num_experts_per_tok": 8}, 4, 5)
    assert k2 - base == 4 * 5 * 2 * (4 * 3 * 2 * 64 * 32)
    assert moe_counts.optimize_step(cfg) > 3 * moe_counts.teacher_flops(cfg)


def test_the_gmm_bound_is_the_slower_of_flops_and_bytes():
    """At the published widths a decode step's products are bound by their
    bytes (every expert's weights for 1,024 rows), the back-translation
    pass's by their FLOPs."""
    cfg = Manifest(ROOT).config(Manifest(ROOT).cell(CELL))
    w = 32 * 2048 * 1792 * 2
    rows = 256 * 4
    flops = 2 * rows * 2048 * 1792
    assert flops / PEAK_OPS_S["bfloat16"] < (w + rows * (2048 + 1792) * 2) / PEAK_BYTES_S
    rows = 256 * 36 * 4
    assert 2 * rows * 2048 * 1792 / PEAK_OPS_S["bfloat16"] > (
        w + rows * (2048 + 1792) * 2) / PEAK_BYTES_S
    bound = moe_counts.gmm_bound_ms(cfg)
    assert 30 < bound < 300  # ms a step: 6 layers, 36 + 36 calls with gradients, 19 without


def test_route_tables_put_each_call_at_its_positions():
    B, L, n, k = 2, 3, 2, 4
    calls, mark = [], iter(range(1000))

    def call(rows):
        v = next(mark)
        calls.append(torch.full((rows, k), v))
        return v

    g_source = [call(B * L) for _ in range(n)]
    g_steps = [[call(B) for _ in range(n)] for _ in range(L)]
    bt = [call(B * 2 * L) for _ in range(n)]
    d_source = [call(B * L) for _ in range(n)]
    [[call(B) for _ in range(n)] for _ in range(L)]
    t = route_tables(calls, B, L, n)
    assert t["g_st"].shape == (n, B, 2 * L, k)
    assert int(t["g_st"][1, 0, 0, 0]) == g_source[1]
    assert int(t["g_st"][0, 1, L + 2, 0]) == g_steps[2][0]
    assert int(t["g_bt"][1, 1, 5, 3]) == bt[1]
    assert int(t["d_st"][0, 0, L - 1, 0]) == d_source[0]
    with pytest.raises(ValueError):
        route_tables(calls[:-1], B, L, n)


def test_readers():
    from portbench.lib import moe_readers
    from portbench.lib.trace import DeviceTrace

    m = Manifest(ROOT)
    load = m.reader("moe_load_ratio.optimize_lfm2").read
    assert load({"moe_load": [[4, 4, 4, 4], [8, 4, 2, 2]]}) == 2.0
    assert load({}) is None
    name = "void cutlass::device_kernel<GemmUniversal<cutlass::gemm::GroupProblemShape<>>>"
    trace = DeviceTrace([(0.0, 0.002, name), (0.001, 0.003, name), (0.004, 0.005, "other")],
                        0.0, 0.01)
    r = {"trace": trace, "trace_steps": 2, "gmm_bound_ms": 0.6}
    assert m.reader("moe_gemm_ms.optimize_lfm2").read(r) == pytest.approx(1.5)
    assert m.reader("moe_gemm_roofline.optimize_lfm2").read(r) == pytest.approx(40.0)
    assert moe_readers.gmm_ms({"trace": DeviceTrace([], 0.0, 1.0), "trace_steps": 1}) is None


def reads_far_above(reading: dict, checks: dict) -> bool:
    """A compared number reads above ten times a sound run's, and above
    0. (The limits are set at the cell's own size, where a bfloat16
    program reads above nought; at this size, in float32, a sound run
    reads nought or round-off.)"""
    return any(reading[k] > max(10 * checks[k]["value"], 0.0) for k in checks)


def test_sound_run_is_correct_and_the_control_reads_above(sound):
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] > 0 and sound["failed"] == 0
    assert set(sound["metrics"]) == {"optimize_sent_per_s", "setup_s"}
    for name in ("control", "top3", "conv_shift", "half_batch", "unchanged"):
        assert reads_far_above(sound["control"][name], sound["checks"]), name


def test_top3_routing_reads_far_above_a_sound_run(checkout, sound, narrow_port, monkeypatch):
    """Each token's last expert dropped, the gates over the other 3."""
    from consistent__style_transfer_torch.models import moe

    real = moe.Router.forward

    def top3(self, x, cast):
        gates, experts = real(self, x, cast)
        gates = torch.cat([gates[:, :3], torch.zeros_like(gates[:, 3:])], dim=-1)
        return gates / gates.sum(-1, keepdim=True), experts

    monkeypatch.setattr(moe.Router, "forward", top3)
    out = run_cell(checkout)
    assert reads_far_above({k: v["value"] for k, v in out["checks"].items()}, sound["checks"])
    assert out["checks"]["token_gap"]["value"] > 10 * sound["checks"]["token_gap"]["value"]


def test_a_conv_state_left_behind_in_decode_is_not_correct(checkout, sound, narrow_port,
                                                          monkeypatch):
    """Each cached step hands on the conv state it was given, one step
    behind the one it should (its last two rows of ``u``)."""
    from consistent__style_transfer_torch.models import lfm2_moe

    real = lfm2_moe.ShortConv.forward

    def behind(self, x, cast, pos0, state=None):
        out, new = real(self, x, cast, pos0, state)
        return out, (new if state is None else state)

    monkeypatch.setattr(lfm2_moe.ShortConv, "forward", behind)
    out = run_cell(checkout)
    assert not out["correct"], out["checks"]
    assert out["checks"]["token_gap"]["value"] > out["checks"]["token_gap"]["limit"]


def test_a_wrong_update_is_not_correct(checkout, sound, narrow_port, monkeypatch):
    """Every Adam step twice as long: the judged transfers start from the
    seeded weights and read nothing of it, the change after the steps
    does."""
    from consistent__style_transfer_torch.train import state

    real = state.AdamWithClip.__init__

    def doubled(self, params, lr, clip, group=None):
        real(self, params, 2 * lr, clip, group)

    monkeypatch.setattr(state.AdamWithClip, "__init__", doubled)
    out = run_cell(checkout)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] > out["checks"]["change_gap"]["limit"]


def test_the_configuration_keeps_the_catalog_row():
    """Every number of the published config is the file's, but the two
    keys listed as reduced; the widths the port publishes are the
    file's."""
    from consistent__style_transfer_torch.models import lfm2_moe
    from portbench.drivers.optimize_lfm2 import check_widths

    m = Manifest(ROOT)
    cfg = m.config(m.cell(CELL))
    entry = m.configs["yelp-lfm2moe"]
    assert entry["reduced"] == ["num_hidden_layers", "vocab_size"]
    assert cfg["published"] == {"num_hidden_layers": 24, "vocab_size": 65536}
    assert cfg["num_hidden_layers"] == 8 and cfg["vocab_size"] == 10000
    assert len(cfg["layer_types"]) == 24 and list(lfm2_moe.LAYER_TYPES) == cfg["layer_types"]
    check_widths(cfg)
    with open(os.path.join(ROOT, "portbench", "limits", f"{CELL}.json")) as f:
        assert set(json.load(f)) == {"change_gap", "token_gap", "rows_missing",
                                     "input_rows_unmoved", "route_flip_pct"}
