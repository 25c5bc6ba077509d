"""The LSTM cell's dispatch and the plain forms of its fused kernels
(``kernels/lstm_cell.py``), on the CPU: which inputs the CUDA kernels take,
that CUDA inputs they do not take raise and CPU tensors run the reference,
the backward equations the kernel implements under ``gradcheck`` in
float64, the library's name keyed by its source, and the replay counters a
graphed step adds for each counted kernel. The kernels themselves run in
``test_torch_lstm_cell_cuda.py`` on the card."""

import shutil
from types import SimpleNamespace

import pytest
import torch

from consistent__style_transfer_torch.kernels import _build
from consistent__style_transfer_torch.kernels import lstm_cell as lc
from consistent__style_transfer_torch.models.generator import LSTM
from consistent__style_transfer_torch.train import graphs
from consistent__style_transfer_torch.utils import profiling

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


class Stub:
    """What :func:`lc._pair` reads of a tensor, on any device."""

    def __init__(self, shape, dtype, device="cuda", col_stride=1):
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device(device)
        self.strides = (shape[-1] * col_stride, col_stride)

    def dim(self):
        return len(self.shape)

    def stride(self, i):
        return self.strides[i]


def stubs(gates=BF16, state=F32, B=4, H=8, **kw):
    return Stub((B, 4 * H), gates), Stub((B, 4 * H), kw.pop("b", gates)), Stub((B, H), state, **kw)


@pytest.mark.parametrize("gates,state,pair", [(BF16, F32, 0), (BF16, BF16, 1), (F32, F32, 2)])
def test_the_kernel_takes_its_three_dtype_pairs(gates, state, pair):
    assert lc._pair(*stubs(gates, state)) == pair


@pytest.mark.parametrize("case,error", [
    ("f16", TypeError), ("f32_gates_bf16_state", TypeError), ("mixed_gates", TypeError),
    ("f64", TypeError), ("shape", ValueError), ("empty", ValueError), ("three_d", ValueError),
    ("devices", ValueError)])
def test_cuda_inputs_the_kernel_does_not_take_raise(case, error):
    """On CUDA tensors nothing falls back to the plain equations: another
    dtype pair is a TypeError, another shape or a mix of devices a
    ValueError, raised before any launch."""
    a, b, c = stubs()
    if case == "f16":
        a, b, c = stubs(F16, F16)
    elif case == "f32_gates_bf16_state":
        a, b, c = stubs(F32, BF16)
    elif case == "mixed_gates":
        a, b, c = stubs(b=F32)
    elif case == "f64":
        a, b, c = stubs(torch.float64, torch.float64)
    elif case == "shape":
        b = Stub((4, 16), BF16)
    elif case == "empty":
        a, b, c = stubs(B=0)
    elif case == "three_d":
        c = Stub((2, 4, 8), F32)
    elif case == "devices":
        c = Stub((4, 8), F32, device="cuda:1")
    fwd = lc.lstm_cell_fwd.launches
    with pytest.raises(error):
        lc.lstm_cell(a, b, c)
    assert lc.lstm_cell_fwd.launches == fwd


def test_the_kernel_takes_a_column_strided_c():
    """A c with a column stride other than 1 is the kernel's: the wrapper
    hands it a contiguous copy (``_unit_cols``), as it does dh and dc_new."""
    assert lc._pair(*stubs(col_stride=2)) == 0
    c = torch.arange(12.0).reshape(3, 4)[:, ::2]
    assert c.stride(-1) == 2
    got = lc._unit_cols(c)
    assert got.stride(-1) == 1 and torch.equal(got, c)
    assert lc._unit_cols(got) is got


def cell_inputs(B=3, H=5, gates=F32, state=F32, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(B, 4 * H, generator=g).to(gates) for _ in range(2))
    c = torch.randn(B, H, generator=g).to(state)
    return [t.requires_grad_(grad) for t in (a, b, c)]


@pytest.mark.parametrize("gates,state", [(F32, F32), (BF16, F32), (BF16, BF16), (F16, F32)])
def test_cpu_cells_run_the_reference_uncounted(gates, state):
    """CPU tensors of any dtype pair run the plain equations, as before the
    kernel, and count no launch."""
    a, b, c = cell_inputs(gates=gates, state=state)
    fwd, bwd = lc.lstm_cell_fwd.launches, lc.lstm_cell_bwd.launches
    h, c_new = lc.lstm_cell(a, b, c)
    h_ref, c_ref = lc.lstm_cell_reference(a, b, c)
    assert torch.equal(h, h_ref) and torch.equal(c_new, c_ref)
    assert h.dtype == c_new.dtype == torch.promote_types(gates, state)
    assert (lc.lstm_cell_fwd.launches, lc.lstm_cell_bwd.launches) == (fwd, bwd)


def test_lstm_module_cell_is_the_reference_on_the_cpu():
    """``LSTM.cell`` hands its two products to the cell: on the CPU that is
    the equations it ran inline before the kernel, under autocast too."""
    torch.manual_seed(0)
    lstm = LSTM(6, 4)
    for p in lstm.parameters():
        torch.nn.init.uniform_(p, -0.5, 0.5)
    x, h, c = torch.randn(3, 6), torch.randn(3, 4), torch.randn(3, 4)
    with torch.autocast("cpu", dtype=BF16):
        got = lstm.cell(x, h, c)
        a = torch.nn.functional.linear(x, lstm.weight_ih_l0, lstm.bias_ih_l0)
        b = torch.nn.functional.linear(h, lstm.weight_hh_l0, lstm.bias_hh_l0)
        gates = a + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c_want = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_want = torch.sigmoid(o) * torch.tanh(c_want)
    assert torch.equal(got[0], h_want) and torch.equal(got[1], c_want)


@pytest.mark.parametrize("outputs", ["both", "h", "c_new"])
def test_backward_equations_pass_gradcheck_in_float64(outputs):
    """The fused Function on the CPU runs the plain forms of both kernels:
    its backward (``lstm_cell_backward_reference``, the kernel's equations)
    against numerical derivatives; a missing output gradient is zero."""
    a, b, c = (t.detach().double().requires_grad_() for t in cell_inputs(B=2, H=3))
    pick = {"both": lambda o: o, "h": lambda o: o[0], "c_new": lambda o: o[1]}[outputs]
    assert torch.autograd.gradcheck(lambda *t: pick(lc.FusedCell.apply(*t)), (a, b, c))


@pytest.mark.parametrize("gates,state", [(F32, F32), (BF16, F32), (BF16, BF16)])
def test_backward_reference_matches_autograd_in_its_types(gates, state):
    """The plain backward returns dgates in the gates' type and dc in c's,
    and agrees with autograd through the float64 reference to the rounding
    of its outputs."""
    a, b, c = cell_inputs(B=4, H=6, gates=gates, state=state, seed=1)
    g = torch.Generator().manual_seed(2)
    dh, dcn = (torch.randn(4, 6, generator=g).to(state) for _ in range(2))
    dgates, dc = lc.lstm_cell_backward_reference(a + b, c, lc.lstm_cell_reference(a, b, c)[1],
                                                 dh, dcn)
    assert dgates.dtype == gates and dc.dtype == state
    a64, c64 = (a + b).double().requires_grad_(), c.double().requires_grad_()
    h64, cn64 = lc.lstm_cell_reference(a64, torch.zeros_like(a64), c64)
    torch.autograd.backward((h64, cn64), (dh.double(), dcn.double()))
    tol = 2e-2 if BF16 in (gates, state) else 1e-5
    assert torch.allclose(dgates.double(), a64.grad, rtol=tol, atol=tol)
    assert torch.allclose(dc.double(), c64.grad, rtol=tol, atol=tol)


def test_library_path_keys_the_new_source(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    before = _build.library_path("lstm_cell", str(csrc))
    assert before == _build.library_path("lstm_cell")
    assert "lstm_cell-" in before and before != _build.library_path("sinkhorn", str(csrc))
    with open(csrc / "sinkhorn.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("lstm_cell", str(csrc)) == before
    with open(csrc / "lstm_cell.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("lstm_cell", str(csrc)) != before


def test_the_cell_kernels_are_counted_kernels():
    for k in (lc.lstm_cell_fwd, lc.lstm_cell_bwd):
        assert k in graphs.COUNTED_KERNELS
    # with the decode head, the Sinkhorn and the expert layer's grouped products
    assert len(graphs.COUNTED_KERNELS) == 5


def test_each_replay_adds_its_launches_to_the_recorder(monkeypatch):
    """A replayed branch adds its captured launches to each kernel's
    ``.launches`` and, while spans record, to the counter
    ``kernel.<name>``."""
    monkeypatch.setattr(profiling.RECORDER, "env", True)
    monkeypatch.setattr(profiling, "device_mark", lambda: None)
    monkeypatch.setattr(profiling, "device_step", lambda start, t_ns: None)
    profiling.RECORDER.clear()
    step = graphs.GraphedStep(lambda inputs, key: None, name="test.step")
    replays = []
    step.static[None] = {"x": torch.zeros(2)}
    step.graphs[None] = SimpleNamespace(replay=lambda: replays.append(1))
    step.outputs[None] = "out"
    step.branches[None] = 0
    step.replay_launches[None] = ((lc.lstm_cell_fwd, 162), (lc.lstm_cell_bwd, 108))
    fwd, bwd = lc.lstm_cell_fwd.launches, lc.lstm_cell_bwd.launches
    try:
        for _ in range(3):
            assert step({"x": torch.ones(2)}) == "out"
        counters = [(n, v) for n, _, v in profiling.RECORDER.counters if n.startswith("kernel.")]
    finally:
        profiling.RECORDER.clear()
    assert len(replays) == 3
    assert lc.lstm_cell_fwd.launches - fwd == 3 * 162
    assert lc.lstm_cell_bwd.launches - bwd == 3 * 108
    assert counters == [("kernel.lstm_cell_fwd", 162), ("kernel.lstm_cell_bwd", 108)] * 3
