"""The fused LSTM cell's CUDA kernels (``csrc/lstm_cell.cu``) against their
plain PyTorch versions on the card. Every test needs a CUDA device and
skips without one. This file imports no JAX, so it runs on a machine that
has only PyTorch (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lstm_cell_cuda.py

Forward: bit-identical to ``lstm_cell_reference`` under autocast, for the
three dtype pairs (gates / cell state) at yelp's encoder (B=256, H=256) and
decoder (H=512) and book's (B=128) shapes.

Inputs: a column-strided c is copied for the kernel; any other dtype pair
raises on the card.

Backward: dgates and dc against autograd through the reference in the same
types, within a relative norm of 2e-2 where bf16 is involved (autograd's
chain rounds to bf16 after every op, at 2^-9 relative each; the kernel once)
and 1e-5 in float32 (the same f32 arithmetic in another order). Both are
also held to float64 autograd through the reference at the same inputs: the
kernel's relative error is at most eager's for the bf16 pairs, and within
1e-5 in float32.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from consistent__style_transfer_torch.kernels import lstm_cell as lc  # noqa: E402
from consistent__style_transfer_torch.models.generator import LSTM  # noqa: E402
from consistent__style_transfer_torch.train.graphs import GraphedStep  # noqa: E402
from consistent__style_transfer_torch.utils.profiling import total  # noqa: E402

pytestmark = pytest.mark.cuda
BF16, F32 = torch.bfloat16, torch.float32
PAIRS = {"bf16_f32": (BF16, F32), "bf16_bf16": (BF16, BF16), "f32_f32": (F32, F32)}
# (B, H): yelp's encoder and decoder, book's; a ragged one on the scalar path
SHAPES = {"yelp_enc": (256, 256), "yelp_dec": (256, 512), "book_enc": (128, 256),
          "book_dec": (128, 512), "ragged": (5, 6)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def inputs(B, H, gates, state, seed=0, scale=2.0):
    """Gate pre-activations over the activations' whole range (a few
    saturated) and a cell state, made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(B, 4 * H, generator=g) * scale for _ in range(2))
    c = torch.randn(B, H, generator=g) * scale
    dh, dcn = (torch.randn(B, H, generator=g) for _ in range(2))
    return ([t.to("cuda", gates) for t in (a, b)] + [c.to("cuda", state)]
            + [t.to("cuda", state) for t in (dh, dcn)])


def rel(x, ref):
    return ((x.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_forward_is_bit_identical_to_the_reference(cuda_device, pair, shape):
    a, b, c, _, _ = inputs(*SHAPES[shape], *PAIRS[pair])
    fwd = total("kernel.lstm_cell_fwd")
    with torch.autocast("cuda", dtype=BF16):
        h, c_new = lc.lstm_cell(a, b, c)
        h_ref, c_ref = lc.lstm_cell_reference(a, b, c)
    torch.cuda.synchronize()
    assert total("kernel.lstm_cell_fwd") == fwd + 1
    assert h.dtype == h_ref.dtype and c_new.dtype == c_ref.dtype
    assert torch.equal(h, h_ref) and torch.equal(c_new, c_ref)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_forward_takes_row_strides(cuda_device, pair):
    """a and b with a row stride past 4H and c a column slice: the same
    bits as contiguous copies give."""
    gates, state = PAIRS[pair]
    a, b, c, _, _ = inputs(64, 128, gates, state, seed=3)
    wide = torch.zeros(64, 4 * 128 + 8, device="cuda", dtype=gates)
    wide[:, :512] = a
    c_wide = torch.cat([c, c], dim=1)
    h, c_new = lc.lstm_cell(wide[:, :512], b, c_wide[:, 128:])
    h_ref, c_ref = lc.lstm_cell(a, b, c.clone())
    assert torch.equal(h, h_ref) and torch.equal(c_new, c_ref)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_a_column_strided_c_is_copied_for_the_kernel(cuda_device, pair):
    """c with a column stride of 2 (forward and backward): the same bits as
    a contiguous c gives, through the kernels."""
    gates, state = PAIRS[pair]
    a, b, c, dh, dcn = inputs(64, 128, gates, state, seed=9)
    strided = torch.stack([c, c], dim=-1)[..., 0]
    assert strided.stride(-1) == 2
    fwd, bwd = total("kernel.lstm_cell_fwd"), total("kernel.lstm_cell_bwd")
    got = grads(a, b, strided, dh, dcn, lc.lstm_cell)
    want = grads(a, b, c, dh, dcn, lc.lstm_cell)
    assert (total("kernel.lstm_cell_fwd") - fwd, total("kernel.lstm_cell_bwd") - bwd) == (2, 2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("gates,state", [(torch.float16, torch.float16), (F32, BF16),
                                         (torch.float64, torch.float64), (BF16, torch.float16)])
def test_other_dtype_pairs_raise_on_the_card(cuda_device, gates, state):
    """No plain fallback on the card: a dtype pair the kernel does not take
    is a TypeError, and nothing launches."""
    a, b, c, _, _ = inputs(8, 16, gates, state)
    fwd = total("kernel.lstm_cell_fwd")
    with pytest.raises(TypeError):
        lc.lstm_cell(a, b, c)
    assert total("kernel.lstm_cell_fwd") == fwd


@pytest.mark.parametrize("pair", ["bf16_f32", "bf16_bf16"])
def test_generator_cells_are_bit_identical_under_autocast(cuda_device, pair):
    """``LSTM.cell`` at yelp's widths, through its two products: the fused
    cell against the reference on the same products."""
    torch.manual_seed(0)
    H, state = (256, F32) if pair == "bf16_f32" else (512, BF16)
    lstm = LSTM(128, H).cuda()
    for p in lstm.parameters():
        torch.nn.init.uniform_(p, -H ** -0.5, H ** -0.5)
    x, h = torch.randn(256, 128, device="cuda"), torch.randn(256, H, device="cuda")
    c = torch.randn(256, H, device="cuda").to(state)
    with torch.autocast("cuda", dtype=BF16):
        got = lstm.cell(x, h, c)
        a = F.linear(x, lstm.weight_ih_l0, lstm.bias_ih_l0)
        b = F.linear(h, lstm.weight_hh_l0, lstm.bias_hh_l0)
        want = lc.lstm_cell_reference(a, b, c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def grads(a, b, c, dh, dcn, fn, dtype=None):
    leaves = [t.detach().to(dtype or t.dtype).requires_grad_() for t in (a, b, c)]
    h, c_new = fn(*leaves)
    torch.autograd.backward((h, c_new), (dh.to(h.dtype), dcn.to(c_new.dtype)))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_backward_against_autograd_and_float64(cuda_device, pair, shape):
    a, b, c, dh, dcn = inputs(*SHAPES[shape], *PAIRS[pair], seed=1)
    bwd = total("kernel.lstm_cell_bwd")
    da, db, dc = grads(a, b, c, dh, dcn, lc.lstm_cell)
    assert total("kernel.lstm_cell_bwd") == bwd + 1
    assert torch.equal(da, db)
    ea, eb, ec = grads(a, b, c, dh, dcn, lc.lstm_cell_reference)
    assert da.dtype == ea.dtype and dc.dtype == ec.dtype
    ra, _, rc = grads(a, b, c, dh, dcn, lc.lstm_cell_reference, torch.float64)
    low = BF16 in PAIRS[pair]
    tol = 2e-2 if low else 1e-5
    assert rel(da, ea.double()) < tol and rel(dc, ec.double()) < tol
    if low:
        assert rel(da, ra) <= rel(ea, ra) and rel(dc, rc) <= rel(ec, rc)
    else:
        assert rel(da, ra) < 1e-5 and rel(dc, rc) < 1e-5


@pytest.mark.parametrize("missing", ["dh", "dc_new"])
def test_backward_with_one_gradient(cuda_device, missing):
    """A cell whose h (or c_new) takes no part in the loss: the missing
    gradient is zero."""
    a, b, c, dh, dcn = inputs(256, 256, BF16, F32, seed=2)
    leaves = [t.detach().requires_grad_() for t in (a, b, c)]
    h, c_new = lc.lstm_cell(*leaves)
    (c_new if missing == "dh" else h).backward(dcn if missing == "dh" else dh)
    zero = torch.zeros_like(dh)
    want = grads(a, b, c, zero if missing == "dh" else dh, zero if missing == "dc_new" else dcn,
                 lc.lstm_cell)
    for got, ref in zip((leaves[0].grad, leaves[2].grad), (want[0], want[2])):
        assert torch.equal(got, ref)


def test_no_grad_forward_is_the_same_kernel(cuda_device):
    a, b, c, _, _ = inputs(256, 512, BF16, BF16, seed=4)
    with torch.no_grad():
        h0, c0 = lc.lstm_cell(a, b, c)
    h1, c1 = lc.lstm_cell(a.requires_grad_(), b, c)
    assert h1.grad_fn is not None
    assert torch.equal(h0, h1) and torch.equal(c0, c1)


def test_one_cell_in_a_cuda_graph_replays_to_the_eager_result(cuda_device):
    """A cell's forward and backward captured by ``GraphedStep``: each replay
    gives the eager kernels' bits; the capture keeps the forward's launch
    and the backward's (made on the autograd engine's thread, on the
    capturing stream), and each replay adds both to the totals."""

    def step(inputs, key):
        leaves = [inputs[k].detach().requires_grad_() for k in ("a", "b", "c")]
        h, c_new = lc.lstm_cell(*leaves)
        torch.autograd.backward((h, c_new), (inputs["dh"], inputs["dcn"]))
        return h, c_new, leaves[0].grad, leaves[2].grad

    run = GraphedStep(step, name="test.lstm_cell")
    names = ("a", "b", "c", "dh", "dcn")
    run(dict(zip(names, inputs(256, 256, BF16, F32, seed=5))))  # eager first call, capture
    fwd, bwd = total("kernel.lstm_cell_fwd"), total("kernel.lstm_cell_bwd")
    for seed in (6, 7, 8):
        batch = dict(zip(names, inputs(256, 256, BF16, F32, seed=seed)))
        got = [t.clone() for t in run(batch)]
        want = step(batch, None)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    torch.cuda.synchronize()
    assert run.replays == 3
    assert run.replay_counts[None] == (("kernel.lstm_cell_fwd", 1), ("kernel.lstm_cell_bwd", 1))
    assert total("kernel.lstm_cell_fwd") - fwd == 3 + 3  # three replays, three eager checks
    assert total("kernel.lstm_cell_bwd") - bwd == 3 + 3
