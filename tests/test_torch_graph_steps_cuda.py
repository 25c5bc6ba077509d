"""The one-dispatch steps (``train/graphs.py::GraphedStep``) on the card:
greedy and beam serving of both backbones, the warmup step of both
backbones and the pretrain step (one graph per tower-flag tuple), each
replayed against its eager step, the validation passes of the three stages
(``train/loop.py::validate`` with a graphed eval step, pretrain's across a
freeze) against eager passes, the decode head's launch count under
replay (none in the beam), and a capture during which a collection of a
dead step's graphs falls due. Greedy serving and the LSTM warmup step also
run at the book preset's L=30. Every test needs a CUDA device and skips
without one. This file imports no JAX, so it
runs on a machine that has only PyTorch (tests/conftest.py imports jax,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_steps_cuda.py

Tolerances:
- serving ids, beam scores and validation losses: equal in float32 (the
  same kernels in the same order);
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
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data.pipeline import Batch  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
    TransformerSeq2Seq,
)
from consistent__style_transfer_torch.models.beam import beam_decode_any  # noqa: E402
from consistent__style_transfer_torch.train import state as state_module  # noqa: E402
from consistent__style_transfer_torch.train.graphs import GraphedStep  # noqa: E402
from consistent__style_transfer_torch.train.infer import make_transfer_step  # noqa: E402
from consistent__style_transfer_torch.train.loop import validate  # noqa: E402
from consistent__style_transfer_torch.train.optimize import VAL_INPUTS, make_optimize_steps  # noqa: E402
from consistent__style_transfer_torch.train.pretrain import (  # noqa: E402
    make_pretrain_steps,
    step_inputs,
)
from consistent__style_transfer_torch.train.state import AdamWithClip, AsyncSaver  # noqa: E402
from consistent__style_transfer_torch.train.warmup import (  # noqa: E402
    EVAL_INPUTS,
    WARMUP_INPUTS,
    make_warmup_steps,
)
from consistent__style_transfer_torch.utils.profiling import total  # noqa: E402

pytestmark = pytest.mark.cuda
V, B, L = 300, 16, 6
BOOK_L = 30  # the book preset's max_len (config.py)
SIZE = dict(d_model=32, n_heads=2, n_layers=2)
G_SIZE = dict(d_model=32, n_heads=4, n_enc=2, n_dec=2, d_ff=64)
LOSS_REL, SHARE, BF16_TOKEN_SHARE = 1e-5, 1e-3, 0.01
P_DROP = 0.1
HEAD = "kernel.fused_decode_logits"  # the decode head's launches


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


def _generator(backbone, device, dtype=torch.float32, rep_penalty=0.0, length=L):
    if backbone == "transformer":
        model = TransformerSeq2Seq(V, 2, length, seed=0, **G_SIZE)
    else:
        model = DenoiseSeq2Seq(V, 2, length, rep_penalty=rep_penalty, seed=0)
    return model.to(device, dtype).eval()


# (backbone, dtype, rep_penalty, max_len); BOOK_L is the book preset's
@pytest.mark.parametrize("backbone, dtype, rep_penalty, length", [
    ("lstm", torch.float32, 0.0, L), ("lstm", torch.bfloat16, 0.0, L),
    ("lstm", torch.float32, 1.0, L), ("transformer", torch.float32, 0.0, L),
    ("lstm", torch.float32, 0.0, BOOK_L)])
def test_graphed_greedy_serving_equals_eager(cuda_device, backbone, dtype, rep_penalty, length):
    model = _generator(backbone, cuda_device, dtype, rep_penalty, length)
    step = make_transfer_step(model)
    rng = np.random.default_rng(0)
    got, want = [], []
    launches = total(HEAD)
    for _ in range(4):  # the eager first call with its capture, then replays
        x, labels = _ints(rng, V, (B, length + 2), cuda_device), _labels(rng, cuda_device)
        got.append(step(x, labels).clone())
        with torch.inference_mode():
            want.append(model(x, labels, None, 1 - labels, mode="greedy"))
    assert isinstance(step.runner, GraphedStep) and list(step.runner.graphs) == [(B, length + 2)]
    if backbone == "lstm" and rep_penalty == 0:  # 4 steps and 4 eager decodes, L heads each
        assert total(HEAD) - launches == 8 * length
    got, want = torch.stack(got), torch.stack(want)
    assert got.shape == (4, B, length) and got.dtype == torch.int32
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


def test_capture_holds_off_a_collection_that_frees_a_dead_graph(cuda_device):
    """A dead step's graphs in cyclic garbage, and a collection due inside
    the next capture: ``GraphedStep`` holds the collector off there
    (``gc_paused``), since destroying a graph while a stream captures
    invalidates the capture. The new step captures and replays right."""
    import gc

    dead = GraphedStep(lambda inputs, key: inputs["x"] * 2)
    x = torch.arange(8.0, device=cuda_device)
    dead({"x": x})
    dead({"x": x})  # captured and replayed: an instantiated graph
    holder = {"dead": dead}
    del dead

    def fn(inputs, key):
        if torch.cuda.is_current_stream_capturing() and "dead" in holder:
            box = [holder.pop("dead")]
            box.append(box)  # the dead step's only reference, in a new cycle
            del box
            junk = [[] for _ in range(100)]  # due for a collection at threshold 1
            del junk
        return inputs["x"] + 1

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        step = GraphedStep(fn)
        first = step({"x": x}).clone()
        second = step({"x": x * 3}).clone()
    finally:
        gc.set_threshold(*threshold)
    assert "dead" not in holder and step.replays == 1
    assert torch.equal(first, x + 1) and torch.equal(second, x * 3 + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_head_launches_count_replays(cuda_device, dtype):
    step = make_transfer_step(_generator("lstm", cuda_device, dtype))
    rng = np.random.default_rng(2)
    x, labels = _ints(rng, V, (B, L), cuda_device), _labels(rng, cuda_device)
    launches = total(HEAD)
    n = 5
    for _ in range(n):
        step(x, labels)
    torch.cuda.synchronize()
    # the first call runs L heads eagerly and captures L more, which run
    # at each of the n - 1 replays
    assert dict(step.runner.replay_counts[(B, L)])[HEAD] == L
    assert total(HEAD) - launches == n * L


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


@pytest.mark.parametrize("backbone, length", [("lstm", L), ("transformer", L), ("lstm", BOOK_L)])
def test_warmup_replays_equal_eager_steps(cuda_device, backbone, length):
    if backbone == "transformer":
        model = TransformerSeq2Seq(V, 2, length, p_drop=P_DROP, seed=1, **G_SIZE)
    else:
        model = DenoiseSeq2Seq(V, 2, length, p_drop=P_DROP, seed=1)
    model = model.to(cuda_device).train()
    opt = AdamWithClip(model.parameters(), 1e-3, 1.0)
    train_step, _ = make_warmup_steps(model, opt)
    gen = torch.Generator(cuda_device).manual_seed(0)
    runner = GraphedStep(lambda inputs, _: train_step(inputs, gen), (gen,))
    rng = np.random.default_rng(3)
    batches = [{"nx": _ints(rng, V, (B, length), cuda_device),
                "x": _ints(rng, V, (B, length), cuda_device),
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



@pytest.mark.parametrize("backbone, K", [("lstm", 4), ("lstm", 2), ("transformer", 4)])
def test_graphed_beam_equals_eager_and_launches_no_head(cuda_device, backbone, K):
    """Ids and scores of every call equal the eager beam's in float32, one
    graph for the one shape; the beam runs the unfused head, so the decode
    head is neither launched nor captured."""
    model = _generator(backbone, cuda_device)
    step = make_transfer_step(model, K)
    rng = np.random.default_rng(5)
    launches = total(HEAD)
    for _ in range(4):  # the eager first call with its capture, then replays
        x, labels = _ints(rng, V, (B, L + 2), cuda_device), _labels(rng, cuda_device)
        ids, scores = (t.clone() for t in step.runner({"x": x, "labels": labels}, (B, L + 2)))
        want_ids, want_scores = beam_decode_any(model, x, labels, 1 - labels, beam_size=K)
        assert torch.equal(ids, want_ids) and torch.equal(scores, want_scores)
    assert torch.equal(step(x, labels), want_ids)
    torch.cuda.synchronize()
    assert isinstance(step.runner, GraphedStep) and list(step.runner.graphs) == [(B, L + 2)]
    assert step.runner.replays == 4
    assert total(HEAD) == launches and HEAD not in dict(step.runner.replay_counts[(B, L + 2)])


def _dev(rng, shapes, n=4, last_valid=5):
    """``n`` dev batches on the host ({key: width, "labels" or "wmd"}), the
    last padded to B with ``last_valid`` real rows."""
    out = []
    for i in range(n):
        arrays = {}
        for k, kind in shapes.items():
            if kind == "labels":
                arrays[k] = rng.integers(0, 2, B).astype(np.int32)
            elif kind == "wmd":
                arrays[k] = rng.random(B).astype(np.float32)
            else:
                arrays[k] = rng.integers(3, V, (B, kind)).astype(np.int32)
        out.append(Batch(arrays, last_valid if i == n - 1 else B))
    return out


def _validations(fn, batches, device, passes=3, **kw):
    """``passes`` validations through a GraphedStep of ``fn`` (the first
    call captures, every later call replays) and as many eager ones."""
    graphed = GraphedStep(fn)
    got = [validate(batches, graphed, device, **kw) for _ in range(passes)]
    want = [validate(batches, fn, device, **kw) for _ in range(passes)]
    return graphed, got, want


def test_warmup_validation_replays_equal_eager_passes(cuda_device):
    model = DenoiseSeq2Seq(V, 2, L, p_drop=P_DROP, seed=1).to(cuda_device)
    _, eval_step = make_warmup_steps(model, AdamWithClip(model.parameters(), 1e-3, 1.0))
    rng = np.random.default_rng(6)
    batches = _dev(rng, {"nx": L, "x": L, "labels": "labels"})
    coins = torch.from_numpy(rng.random(L) < 0.5).to(cuda_device)
    graphed, got, want = _validations(lambda inputs, _: [eval_step(inputs, inputs["coins"])],
                                      batches, cuda_device, inputs=EVAL_INPUTS,
                                      static={"coins": coins})
    assert got == want and np.isfinite(got).all()
    assert list(graphed.graphs) == [None] and graphed.replays == 3 * len(batches) - 1


def test_optimize_validation_replays_equal_eager_passes(cuda_device):
    cfg = make_config("tiny", dtype="float32", max_len=L, device="cuda", scorer_layers=2,
                      scorer_d_model=32, scorer_heads=2)
    models = SimpleNamespace(
        generator=DenoiseSeq2Seq(V, 2, L, p_drop=P_DROP, seed=1), classifier=TextCNN(V, seed=2),
        matcher=PairMatcher(V, seed=3, **SIZE), nt_checker=TransformerLM(V, seed=4, **SIZE),
        disc=RelGANDiscriminator(V, seed=5))
    for m in vars(models).values():
        m.to(cuda_device)
    steps = make_optimize_steps(cfg, models, AdamWithClip(models.generator.parameters(), 1e-5, 1.0),
                                AdamWithClip(models.disc.parameters(), 1e-5, 1.0))
    batches = _dev(np.random.default_rng(7), {"x": L, "labels": "labels"})
    graphed, got, want = _validations(lambda inputs, _: [steps.val_step(inputs)], batches,
                                      cuda_device, inputs=VAL_INPUTS)
    assert got == want and np.isfinite(got).all()
    assert graphed.replays == 3 * len(batches) - 1


def test_pretrain_validation_replays_equal_eager_passes_across_a_freeze(cuda_device):
    """One graph per flag tuple: every tower, then the matcher frozen, its
    inputs left out."""
    towers = {"cls": TextCNN(V, p_drop=P_DROP, seed=2),
              "mat": PairMatcher(V, p_drop=P_DROP, seed=3, **SIZE),
              "dn": TransformerLM(V, p_drop=P_DROP, seed=4, **SIZE)}
    towers = {t: m.to(cuda_device) for t, m in towers.items()}
    _, eval_step = make_pretrain_steps(towers, AdamWithClip(
        [p for m in towers.values() for p in m.parameters()], 1e-3, 5.0))
    nl = L + max(4, L // 2)
    batches = _dev(np.random.default_rng(8), {"x": L, "labels": "labels", "nx1": nl, "nx2": nl,
                                              "nx3": L, "wmd": "wmd"})
    fn = lambda inputs, flags: list(eval_step(inputs, flags).values())  # noqa: E731
    graphed = GraphedStep(fn)
    for flags, n_losses in (((True, True, True), 3), ((True, False, True), 2)):
        kw = dict(shard=False, key=flags, inputs=(*step_inputs(flags), "row_mask"))
        got = [validate(batches, graphed, cuda_device, **kw) for _ in range(3)]
        want = [validate(batches, fn, cuda_device, **kw) for _ in range(3)]
        assert got == want and len(got[0]) == n_losses and np.isfinite(got).all()
    assert sorted(graphed.graphs) == [(True, False, True), (True, True, True)]
    assert graphed.replays == 2 * (3 * len(batches) - 1)
