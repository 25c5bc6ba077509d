"""The one-dispatch steps (``train/graphs.py::GraphedStep``) on the card:
greedy serving of both backbones, the warmup step of both backbones and the
pretrain step (one graph per tower-flag tuple), each replayed against its
eager step, and the decode head's launch count under replay. Every test
needs a CUDA device and skips without one. This file imports no JAX, so it
runs on a machine that has only PyTorch (tests/conftest.py imports jax,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_steps_cuda.py

Tolerances:
- serving ids: equal in float32 (the same kernels in the same order);
  under bf16 at most 1% of the tokens differ (a product summed in another
  order, should cuBLAS pick another kernel on the capture stream, moves a
  logit by a bf16 step and can flip a near-tied argmax, and a flipped
  token changes the rest of its row);
- training steps (tests/test_torch_megastep_cuda.py's float32 bounds):
  losses within 1e-5 relative, the mean absolute difference of the
  parameters within 1e-3 of their mean absolute move (atomics in a
  backward may sum in another order, and a gradient entry near 0 can then
  flip the sign of its Adam step, so the largest difference is not
  bounded), and the generators moved exactly as far. Both runs start from
  the same saved parameters, Adam states and generator states, with
  dropout on.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    TextCNN,
    TransformerLM,
    TransformerSeq2Seq,
)
from consistent__style_transfer_torch.train import state as state_module  # noqa: E402
from consistent__style_transfer_torch.train.common import generator_call  # noqa: E402
from consistent__style_transfer_torch.train.graphs import GraphedStep  # noqa: E402
from consistent__style_transfer_torch.train.infer import make_transfer_step  # noqa: E402
from consistent__style_transfer_torch.train.pretrain import (  # noqa: E402
    make_pretrain_steps,
    step_inputs,
)
from consistent__style_transfer_torch.train.state import AdamWithClip, AsyncSaver  # noqa: E402
from consistent__style_transfer_torch.train.warmup import WARMUP_INPUTS, make_warmup_steps  # noqa: E402

pytestmark = pytest.mark.cuda
V, B, L = 300, 16, 6
SIZE = dict(d_model=32, n_heads=2, n_layers=2)
G_SIZE = dict(d_model=32, n_heads=4, n_enc=2, n_dec=2, d_ff=64)
LOSS_REL, SHARE, BF16_TOKEN_SHARE = 1e-5, 1e-3, 0.01
P_DROP = 0.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ints(rng, high, shape, device):
    return torch.from_numpy(rng.integers(3, high, shape).astype(np.int32)).to(device)


def _labels(rng, device):
    return torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).to(device)


def _generator(backbone, device, dtype=torch.float32, rep_penalty=0.0):
    if backbone == "transformer":
        model = TransformerSeq2Seq(V, 2, L, seed=0, **G_SIZE)
    else:
        model = DenoiseSeq2Seq(V, 2, L, rep_penalty=rep_penalty, seed=0)
    return model.to(device, dtype).eval()


@pytest.mark.parametrize("backbone, dtype, rep_penalty", [
    ("lstm", torch.float32, 0.0), ("lstm", torch.bfloat16, 0.0), ("lstm", torch.float32, 1.0),
    ("transformer", torch.float32, 0.0)])
def test_graphed_greedy_serving_equals_eager(cuda_device, backbone, dtype, rep_penalty):
    model = _generator(backbone, cuda_device, dtype, rep_penalty)
    step = make_transfer_step(model)
    rng = np.random.default_rng(0)
    got, want = [], []
    for _ in range(4):  # the eager first call with its capture, then replays
        x, labels = _ints(rng, V, (B, L + 2), cuda_device), _labels(rng, cuda_device)
        got.append(step(x, labels).clone())
        with torch.inference_mode():
            want.append(generator_call(model, x, labels, None, 1 - labels, mode="greedy"))
    assert isinstance(step.runner, GraphedStep) and list(step.runner.graphs) == [(B, L + 2)]
    got, want = torch.stack(got), torch.stack(want)
    assert got.shape == (4, B, L) and got.dtype == torch.int32
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert float((got != want).float().mean()) <= BF16_TOKEN_SHARE


def test_graph_output_is_overwritten_by_the_next_call(cuda_device):
    step = make_transfer_step(_generator("lstm", cuda_device))
    rng = np.random.default_rng(1)
    a = step(_ints(rng, V, (B, L), cuda_device), _labels(rng, cuda_device))  # eager
    b = step(_ints(rng, V, (B, L), cuda_device), _labels(rng, cuda_device))  # replay
    c = step(_ints(rng, V, (B, L), cuda_device), _labels(rng, cuda_device))
    # one buffer for every replay: copy the ids before the next call
    assert c.data_ptr() == b.data_ptr() != a.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_head_launches_count_replays(cuda_device, dtype):
    step = make_transfer_step(_generator("lstm", cuda_device, dtype))
    rng = np.random.default_rng(2)
    x, labels = _ints(rng, V, (B, L), cuda_device), _labels(rng, cuda_device)
    launches, captured = fused_decode_logits.launches, fused_decode_logits.captured
    n = 5
    for _ in range(n):
        step(x, labels)
    torch.cuda.synchronize()
    # the first call runs L heads eagerly and captures L more, which run
    # at each of the n - 1 replays
    assert fused_decode_logits.captured - captured == L
    assert fused_decode_logits.launches - launches == n * L


def _snapshot(tensors):
    torch.cuda.synchronize()
    return [t.detach().clone() for t in tensors]


def _restore(tensors, saved, gens, gen_states):
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    for g, s in zip(gens, gen_states):
        g.set_state(s)


def _state(modules, opt):
    params = [p for m in modules for p in m.parameters()]
    adam = [t for st in opt.adam.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]
    return params, params + adam


def _mean_abs(xs, ys):
    return float(torch.cat([(x - y).abs().flatten() for x, y in zip(xs, ys)]).mean())


def _compare(eager, graphed, start):
    (l0, p0, g0), (l1, p1, g1) = eager, graphed
    assert torch.isfinite(l0).all()
    assert float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max()) <= LOSS_REL
    move = _mean_abs(p0, start)
    assert move > 1e-6  # the steps moved the parameters
    assert _mean_abs(p1, p0) <= SHARE * move
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))


@pytest.mark.parametrize("backbone", ["lstm", "transformer"])
def test_warmup_replays_equal_eager_steps(cuda_device, backbone):
    if backbone == "transformer":
        model = TransformerSeq2Seq(V, 2, L, p_drop=P_DROP, seed=1, **G_SIZE)
    else:
        model = DenoiseSeq2Seq(V, 2, L, p_drop=P_DROP, seed=1)
    model = model.to(cuda_device).train()
    opt = AdamWithClip(model.parameters(), 1e-3, 1.0)
    train_step, _ = make_warmup_steps(model, opt)
    gen = torch.Generator(cuda_device).manual_seed(0)
    runner = GraphedStep(lambda inputs, _: train_step(inputs, gen), (gen,))
    rng = np.random.default_rng(3)
    batches = [{"nx": _ints(rng, V, (B, L), cuda_device), "x": _ints(rng, V, (B, L), cuda_device),
                "labels": _labels(rng, cuda_device)} for _ in range(8)]
    runner({k: batches[0][k] for k in WARMUP_INPUTS})  # the eager step, then the capture
    assert list(runner.graphs) == [None]
    params, state = _state([model], opt)
    saved, saved_gen = _snapshot(state), [gen.get_state()]
    runs = []
    for graphed in (False, True):
        _restore(state, saved, [gen], saved_gen)
        losses = [(runner({k: b[k] for k in WARMUP_INPUTS}) if graphed
                   else train_step(b, gen)).clone() for b in batches[1:]]
        runs.append((torch.stack(losses), _snapshot(params), [gen.get_state()]))
    _compare(*runs, saved[:len(params)])


def test_pretrain_replays_equal_eager_steps_across_a_freeze(cuda_device, monkeypatch,
                                                            tmp_path):
    towers = {"cls": TextCNN(V, p_drop=P_DROP, seed=2),
              "mat": PairMatcher(V, p_drop=P_DROP, seed=3, **SIZE),
              "dn": TransformerLM(V, p_drop=P_DROP, seed=4, **SIZE)}
    towers = {t: m.to(cuda_device) for t, m in towers.items()}
    opt = AdamWithClip([p for m in towers.values() for p in m.parameters()], 1e-3, 5.0)
    train_step, _ = make_pretrain_steps(towers, opt)
    gen = torch.Generator(cuda_device).manual_seed(0)

    # a save that is still copying to the host when the next flag tuple is
    # captured, as after a freeze at an epoch's end
    real_save, pending = state_module.save_state_dict, threading.Event()

    def slow_save(sd, path):
        pending.wait(timeout=30)
        time.sleep(0.2)
        real_save(sd, path)

    monkeypatch.setattr(state_module, "save_state_dict", slow_save)
    saver = AsyncSaver()
    waits = []

    def drain():
        waits.append(saver._q.unfinished_tasks)
        saver.wait()

    runner = GraphedStep(lambda inputs, flags: train_step(inputs, flags, gen), (gen,),
                         before_capture=drain)
    rng = np.random.default_rng(4)
    nl = L + max(4, L // 2)
    batches = [{"x": _ints(rng, V, (B, L), cuda_device), "labels": _labels(rng, cuda_device),
                "nx1": _ints(rng, V, (B, nl), cuda_device), "nx2": _ints(rng, V, (B, nl), cuda_device),
                "nx3": _ints(rng, V, (B, L), cuda_device),
                "wmd": torch.from_numpy(rng.random(B).astype(np.float32)).to(cuda_device)}
               for _ in range(8)]
    full, frozen = (True, True, True), (True, False, True)

    def step(b, flags, graphed):
        if graphed:
            parts = runner({k: b[k] for k in step_inputs(flags)}, flags)
        else:
            parts = train_step(b, flags, gen)
        return torch.stack([parts[t] for t in sorted(parts)]).clone()

    step(batches[0], full, True)
    saver.submit(towers["mat"], str(tmp_path / "mat.pth"))
    pending.set()
    step(batches[1], frozen, True)  # waits for the save, then captures
    assert waits == [0, 1] and sorted(runner.graphs) == [frozen, full]
    saver.close()

    params, state = _state(towers.values(), opt)
    saved, saved_gen = _snapshot(state), [gen.get_state()]
    order = [full, frozen, full, frozen, frozen, frozen]
    runs = []
    for graphed in (False, True):
        _restore(state, saved, [gen], saved_gen)
        losses = [step(b, flags, graphed) for b, flags in zip(batches[2:], order)]
        runs.append((torch.cat(losses), _snapshot(params), [gen.get_state()]))
    _compare(*runs, saved[:len(params)])

