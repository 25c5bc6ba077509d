"""Validation through ``train/loop.py::validate`` and the stage's runner
(``train/graphs.py::step_runner``, which the CPU runs eagerly) against the
JAX package's eval steps and its validation loops' weighting (each batch's
loss times its real rows, over the sum of the real rows), on the same
weights and dev batches, on the CPU in float32 with dropout off:

- warmup: ``eval_step`` with the validation's sched coins a static input;
  the JAX step is traced with the same coins (``jax.random.bernoulli``
  replaced while it traces, a test-side patch);
- pretrain: ``eval_step`` keyed by the flag tuple, all three towers and
  then the matcher frozen (its inputs left out);
- optimize: ``val_step`` (an ``st`` decode without dropout or coins).

Each runs over three dev batches made with numpy from a seed, the last
padded (1 real row of 4). Losses within 1e-5.

Then the runner's outputs as a CUDA graph gives them: one set of buffers
that every call overwrites. ``validate`` queues each batch's product before
the next call, so its result is the plain step's, bit for bit; products
taken after the next call would all read the last batch's losses, which
the test shows differ.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.data import pipeline as jax_pipeline  # noqa: E402
from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.train import common as jax_common  # noqa: E402
from consistent__style_transfer_tpu.train import optimize as jax_optimize  # noqa: E402
from consistent__style_transfer_tpu.train.pretrain import (  # noqa: E402
    make_pretrain_steps as jax_pretrain_steps,
)
from consistent__style_transfer_tpu.train.warmup import make_warmup_steps as jax_warmup_steps  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data.pipeline import Batch, eval_arrays  # noqa: E402
from consistent__style_transfer_torch.data.prefetch import to_device  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.train import optimize, pretrain, warmup  # noqa: E402
from consistent__style_transfer_torch.train.graphs import step_runner  # noqa: E402
from consistent__style_transfer_torch.train.loop import validate  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import interop  # noqa: E402

V, B, L = 30, 4, 6
LN = L + L // 2  # the pretrain collate's noise width
DEV_VALID = (4, 4, 1)  # real rows of the three dev batches: the last padded
COINS = np.array([0, 1, 1, 0, 1, 0], bool)
SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)
CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dev(shapes: dict, seed: int) -> list[Batch]:
    """Three dev batches of the arrays ``shapes`` ({key: "labels", "wmd" or
    the width of an id array}), numpy from ``seed``; the padded rows of the
    last repeat its row 0, as the pipeline pads."""
    rng = np.random.default_rng(seed)
    out = []
    for valid in DEV_VALID:
        arrays = {}
        for k, kind in shapes.items():
            if kind == "labels":
                a = rng.integers(0, 2, B).astype(np.int32)
            elif kind == "wmd":
                a = rng.uniform(0, 2, B).astype(np.float32)
            else:
                a = rng.integers(3, V, (B, kind)).astype(np.int32)
            a[valid:] = a[0]
            arrays[k] = a
        out.append(Batch(arrays, valid))
    return out


def _jax_mean(losses: list[dict], batches: list[Batch]) -> dict:
    """The JAX loops' validation value: sum of loss * valid over sum of
    valid, per loss."""
    weight = sum(b.valid for b in batches)
    return {k: sum(float(ls[k]) * b.valid for ls, b in zip(losses, batches)) / weight
            for k in losses[0]}


def _reused_buffers(runner):
    """``runner`` with its outputs copied into one set of buffers that every
    call overwrites and returns, as a CUDA graph replay does."""
    bufs = []

    def run(inputs, key=None):
        out = runner(inputs, key)
        if not bufs:
            bufs.extend(torch.empty_like(v) for v in out)
        for b, v in zip(bufs, out):
            b.copy_(v)
        return list(bufs)

    return run


# ---------------------------------------------------------------- warmup


@functools.cache
def _warmup_case():
    model = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
    x0, l0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), x0, l0, x0, l0,
                                                 deterministic=True))
    _, eval_step = jax_warmup_steps(model)
    batches = _dev({"nx": L, "x": L, "labels": "labels"}, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(COINS[: shape[0]]))
        losses = [{"dn": eval_step(params, jax_pipeline.eval_arrays(b),
                                   {"coin": jax.random.PRNGKey(3)})} for b in batches]
    port = DenoiseSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
    port.load_state_dict(interop.generator_state_dict_from_jax(params), strict=True)
    _, port_eval = warmup.make_warmup_steps(port, AdamWithClip(port.parameters(), 1e-3, 1.0))
    runner = step_runner(lambda inputs, _: [port_eval(inputs, inputs["coins"])], CPU)
    kw = dict(inputs=warmup.EVAL_INPUTS, static={"coins": torch.from_numpy(COINS)})
    return batches, runner, kw, _jax_mean(losses, batches)


def test_warmup_validation_equals_jax():
    batches, runner, kw, want = _warmup_case()
    got = validate(batches, runner, CPU, **kw)
    assert got[0] == pytest.approx(want["dn"], rel=TOL, abs=TOL)


# ---------------------------------------------------------------- pretrain

PRE_SHAPES = {"x": L, "labels": "labels", "nx1": LN, "nx2": LN, "nx3": L, "wmd": "wmd"}


@functools.cache
def _pretrain_case():
    cfg = jax_make_config("tiny", dtype="float32", max_len=L, **SCORER)
    models = {"cls": jax_common.build_classifier(cfg, V), "mat": jax_common.build_matcher(cfg, V),
              "dn": jax_common.build_lm(cfg, V)}
    kc, km, kd = jax.random.split(jax.random.PRNGKey(5), 3)
    x0, n0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2, LN), jnp.int32)
    params = jax.tree.map(np.asarray, {"cls": models["cls"].init(kc, x0),
                                       "mat": models["mat"].init(km, n0, n0),
                                       "dn": models["dn"].init(kd, x0)})
    _, eval_step = jax_pretrain_steps(models)
    towers = {"cls": TextCNN(V, p_drop=0.0), "mat": PairMatcher(V, p_drop=0.0, **PORT_SIZE),
              "dn": TransformerLM(V, p_drop=0.0, **PORT_SIZE)}
    to_sd = {"cls": interop.classifier_state_dict_from_jax,
             "mat": interop.matcher_state_dict_from_jax, "dn": interop.lm_state_dict_from_jax}
    for t, m in towers.items():
        m.load_state_dict(to_sd[t](params[t]), strict=True)
    _, port_eval = pretrain.make_pretrain_steps(towers, AdamWithClip(
        [p for m in towers.values() for p in m.parameters()], 1e-4, 5.0))
    # the stage's runner: one per flag tuple, eval_step's losses in TASKS order
    runner = step_runner(lambda inputs, flags: list(port_eval(inputs, flags).values()), CPU)
    return eval_step, params, runner


@pytest.mark.parametrize("flags", [(True, True, True), (True, False, True)])
def test_pretrain_validation_equals_jax(flags):
    """Every tower, and the matcher frozen: its inputs are not given."""
    eval_step, params, runner = _pretrain_case()
    batches = _dev(PRE_SHAPES if flags[1] else {k: v for k, v in PRE_SHAPES.items()
                                               if k not in ("nx1", "nx2", "wmd")}, seed=2)
    want = _jax_mean([eval_step(params, jax_pipeline.eval_arrays(b), flags) for b in batches],
                     batches)
    got = validate(batches, runner, CPU, shard=False, key=flags,
                   inputs=(*pretrain.step_inputs(flags), "row_mask"))
    active = [t for t, on in zip(pretrain.TASKS, flags) if on]
    assert sorted(want) == sorted(active) and len(got) == len(active)
    for t, g in zip(active, got):
        assert g == pytest.approx(want[t], rel=TOL, abs=TOL), t


# ---------------------------------------------------------------- optimize


@functools.cache
def _optimize_case():
    jcfg = jax_make_config("tiny", dtype="float32", max_len=L, **SCORER)
    jm = jax_optimize.OptimizeModels(jcfg, V)
    kc, km, kn, kg = jax.random.split(jax.random.PRNGKey(7), 4)
    x0, l0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    n0 = jnp.zeros((2, LN), jnp.int32)
    frozen = jax.tree.map(np.asarray, {"cls": jm.classifier.init(kc, x0),
                                       "mat": jm.matcher.init(km, n0, n0),
                                       "nt": jm.nt_checker.init(kn, x0)})
    g = jax.tree.map(np.asarray, jm.generator.init(kg, x0, l0, None, l0, deterministic=True))
    val_step = jax_optimize.make_optimize_steps(jcfg, jm).val_step
    batches = _dev({"x": L, "labels": "labels"}, seed=3)
    want = _jax_mean([{"val": val_step(g, frozen, jax_pipeline.eval_arrays(b))}
                      for b in batches], batches)
    cfg = make_config("tiny", dtype="float32", max_len=L, device="cpu", **SCORER)
    models = SimpleNamespace(generator=DenoiseSeq2Seq(V, 2, L), classifier=TextCNN(V),
                             matcher=PairMatcher(V, **PORT_SIZE),
                             nt_checker=TransformerLM(V, **PORT_SIZE),
                             disc=RelGANDiscriminator(V))
    models.generator.load_state_dict(interop.generator_state_dict_from_jax(g), strict=True)
    models.classifier.load_state_dict(interop.classifier_state_dict_from_jax(frozen["cls"]))
    models.matcher.load_state_dict(interop.matcher_state_dict_from_jax(frozen["mat"]))
    models.nt_checker.load_state_dict(interop.lm_state_dict_from_jax(frozen["nt"]))
    steps = optimize.make_optimize_steps(
        cfg, models, AdamWithClip(models.generator.parameters(), 1e-5, 1.0),
        AdamWithClip(models.disc.parameters(), 1e-5, 1.0))
    runner = step_runner(lambda inputs, _: [steps.val_step(inputs)], CPU)
    return batches, runner, dict(inputs=optimize.VAL_INPUTS), want


def test_optimize_validation_equals_jax():
    batches, runner, kw, want = _optimize_case()
    got = validate(batches, runner, CPU, **kw)
    assert got[0] == pytest.approx(want["val"], rel=TOL, abs=TOL)


# ---------------------------------------------------------------- the replay's buffers


@pytest.mark.parametrize("case", [_warmup_case, _optimize_case])
def test_validate_reads_each_batch_before_the_next_replay(case):
    """Outputs in one overwritten buffer give the plain step's sums bit for
    bit; products taken only after the last call would read its losses for
    every batch, which differ here."""
    batches, runner, kw, _ = case()
    plain = validate(batches, runner, CPU, **kw)
    assert validate(batches, _reused_buffers(runner), CPU, **kw) == plain
    reused = _reused_buffers(runner)
    outs = [reused({**to_device({k: eval_arrays(b)[k] for k in kw["inputs"]}, CPU),
                    **kw.get("static", {})}) for b in batches]
    late = sum(float(o[0]) * b.valid for o, b in zip(outs, batches)) / sum(DEV_VALID)
    assert abs(late - plain[0]) > 1e-4
