"""The transformer backbone (``--backbone transformer``) through the port's
training stages and entry points:

- one warmup step and one optimize ``fused_step`` (D applying, and
  accumulating only) against the JAX package's on the same weights and
  batch, on the CPU in float32, dropout off: the losses within 1e-5, G's
  (clipped) gradients and D's accumulator within 1e-4 of each parameter's
  largest entry plus 1e-8 (the key projections' biases have a gradient of
  0 in exact arithmetic, since a constant added to every score leaves the
  softmax as it is, and both frameworks give round-off of about 1e-10
  there), the updated parameters within 1e-6 where the gradient is
  above 1e-4 (elsewhere within 2 lr: Adam's first step is lr times the
  gradient's sign, and a near-zero entry may take either sign in the two
  frameworks);
- the configuration (``--backbone``, ``--beam_size``, the warmup checkpoint
  name, the generator each backbone builds and its dtype);
- a tiny CPU run of ``warmup``, ``optimize``, ``infer`` and ``serve``
  through the CLI with ``--backbone transformer --beam_size 4 --device cpu``
  at the full T5-small widths.

The JAX transformer is narrowed for the parity cases as in
test_torch_seq2seq_transformer.py (its width constants set while the JAX
steps are traced, a test-side patch); its scorers' dropout is turned off by
replacing ``flax.linen.Dropout`` while they trace (their rates are module
constants), as test_torch_optimize_step.py does. The transformer draws no
sched coins on either side.
"""

import os
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import consistent__style_transfer_tpu.models.seq2seq_transformer as jax_tf  # noqa: E402
from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.train import optimize as jax_optimize  # noqa: E402
from consistent__style_transfer_tpu.train.state import TrainState, adam_with_clip  # noqa: E402
from consistent__style_transfer_tpu.train.warmup import make_warmup_steps as jax_warmup_steps  # noqa: E402
from consistent__style_transfer_torch import cli  # noqa: E402
from consistent__style_transfer_torch.config import config_from_args, make_config  # noqa: E402
from consistent__style_transfer_torch.data.prefetch import to_device  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
    TransformerSeq2Seq,
)
from consistent__style_transfer_torch.train import optimize, warmup  # noqa: E402
from consistent__style_transfer_torch.train.common import (  # noqa: E402
    build_generator,
    generator_call,
    get_tokenizer,
)
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import interop  # noqa: E402

V, B, L = 30, 4, 6
LR, CLIP = 1e-3, 1.0
NARROW = dict(D_MODEL=32, N_HEADS=4, HEAD_DIM=8, N_ENC=2, N_DEC=2, D_FF=64)
PORT_NARROW = dict(d_model=32, n_heads=4, n_enc=2, n_dec=2, d_ff=64)
SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)
LOSS_W = dict(w_rec=0.5, w_copy=1.0)  # every branch of the G loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoDropout(flax.linen.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def _record():
    """A transform that passes gradients on and keeps them as its state."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda grads, state, params=None: (grads, grads))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"nx": rng.integers(3, V, (B, L)).astype(np.int32),
            "x": rng.integers(3, V, (B, L)).astype(np.int32),
            "labels": np.array([0, 1, 1, 0], np.int32)}


def _jax_cfg():
    return jax_make_config("tiny", dtype="float32", max_len=L, p_drop=0.0,
                           backbone="transformer", **LOSS_W, **SCORER)


@pytest.fixture(scope="module")
def jax_ref():
    """Initial params of the JAX transformer G, the scorers and D, and the
    JAX results of one warmup step and of one fused step with D applying and
    accumulating only (``fused_step_dyn_fn``, one compile for both)."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    x0, l0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    n0 = jnp.zeros((2, L + L // 2), jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in NARROW.items():
            mp.setattr(jax_tf, k, v)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        models = jax_optimize.OptimizeModels(_jax_cfg(), V)
        assert type(models.generator).__name__ == "TransformerSeq2Seq"
        kc, km, kn, kg, kd = jax.random.split(jax.random.PRNGKey(0), 5)
        frozen = {"cls": models.classifier.init(kc, x0), "mat": models.matcher.init(km, n0, n0),
                  "nt": models.nt_checker.init(kn, x0)}
        g_params = models.generator.init(kg, x0, l0, None, l0, deterministic=True)
        d_params = models.disc.init(kd, x0)
        out = {"frozen": _np(frozen), "g": _np(g_params), "d": _np(d_params)}

        # warmup: one step, and the raw gradients of its loss
        train_step, _ = jax_warmup_steps(models.generator)
        state = TrainState.create(g_params, optax.chain(_record(), adam_with_clip(LR, CLIP)))
        new_state, loss = train_step(state, batch, jax.random.PRNGKey(1), 0)
        out["warmup"] = {"loss": float(loss), "grads": _np(new_state.opt_state[0]),
                         "g": _np(new_state.params)}

        steps = jax_optimize.make_optimize_steps(_jax_cfg(), models)
        fused = jax.jit(steps.fused_step_dyn_fn)
        key = jax.random.PRNGKey(5)
        for do_apply in (True, False):
            tx = optax.chain(_record(), adam_with_clip(LR, CLIP))
            g_state, d_state = TrainState.create(g_params, tx), TrainState.create(d_params, tx)
            acc = jax.tree.map(jnp.zeros_like, d_params)
            g_state, d_state, acc, aux, d_loss = fused(
                g_state, d_state, acc, frozen, {"x": batch["x"], "labels": batch["labels"]},
                key, jax.random.fold_in(key, 1), 0, jnp.asarray(do_apply))
            out[do_apply] = {"aux": {k: float(v) for k, v in aux.items()},
                             "d_loss": float(d_loss), "g_grads": _np(g_state.opt_state[0]),
                             "g": _np(g_state.params), "d_grads": _np(d_state.opt_state[0]),
                             "d": _np(d_state.params), "acc": _np(acc)}
    return out


def _port_generator(params):
    model = TransformerSeq2Seq(V, 2, L, p_drop=0.0, **PORT_NARROW)
    model.load_state_dict(interop.transformer_generator_state_dict_from_jax(params), strict=True)
    return model


def _close_rel(got, want, rel, msg):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-8, f"{msg}: max abs err {err} vs {rel} x {scale}"


def _clipped(grads: dict) -> dict:
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    return {k: g * min(1.0, CLIP / norm) for k, g in grads.items()}


def _check_update(module, after_jax: dict, grads: dict, msg: str):
    for k, p in module.named_parameters():
        diff = (p.detach() - after_jax[k]).abs()
        big = grads[k].abs() > 1e-4
        if big.any():
            assert float(diff[big].amax()) <= 1e-6, f"{msg} {k}"
        assert float(diff.max()) <= 2 * LR + 1e-6, f"{msg} {k}"


def test_warmup_step_matches_jax(jax_ref):
    """The denoising step on the teacher-forced parallel pass: loss, clipped
    gradients and the Adam update."""
    ref = jax_ref["warmup"]
    model = _port_generator(jax_ref["g"])
    opt = AdamWithClip(model.parameters(), LR, CLIP)
    train_step, _ = warmup.make_warmup_steps(model, opt)
    loss = train_step(to_device(_batch(), torch.device("cpu")))
    assert loss.item() == pytest.approx(ref["loss"], rel=1e-5, abs=1e-5)
    grads = _clipped(interop.transformer_generator_state_dict_from_jax(ref["grads"]))
    for k, p in model.named_parameters():
        _close_rel(p.grad, grads[k], 1e-4, f"grad {k}")
    _check_update(model, interop.transformer_generator_state_dict_from_jax(ref["g"]), grads, "G")


def _port_models(ref):
    cfg = make_config("tiny", dtype="float32", max_len=L, p_drop=0.0, device="cpu",
                      backbone="transformer", optimize_lr=LR, optimize_clip=CLIP,
                      **LOSS_W, **SCORER)
    models = SimpleNamespace(
        generator=_port_generator(ref["g"]), classifier=TextCNN(V, p_drop=0.0),
        matcher=PairMatcher(V, p_drop=0.0, **PORT_SIZE),
        nt_checker=TransformerLM(V, p_drop=0.0, **PORT_SIZE),
        disc=RelGANDiscriminator(V, p_drop=0.0))
    models.disc.load_state_dict(interop.discriminator_state_dict_from_jax(ref["d"]), strict=True)
    for m, key, to_sd in ((models.classifier, "cls", interop.classifier_state_dict_from_jax),
                          (models.matcher, "mat", interop.matcher_state_dict_from_jax),
                          (models.nt_checker, "nt", interop.lm_state_dict_from_jax)):
        m.load_state_dict(to_sd(ref["frozen"][key]), strict=True)
        m.requires_grad_(False)
    return cfg, models


@pytest.mark.parametrize("do_apply", [True, False], ids=["apply", "accumulate"])
def test_fused_step_matches_jax(jax_ref, do_apply):
    """The G loss's aux (``G``, ``STI``, ``CP``, ``BK``, ``REC``, ``COPY``,
    ``loss``) and ``d_loss``; G's gradients and update; D's gradients and
    update, or its accumulator with D unchanged. ``time_major_probs`` is on
    in the config and has no effect on this backbone."""
    ref = jax_ref[do_apply]
    cfg, models = _port_models(jax_ref)
    assert cfg.time_major_probs
    g_opt = AdamWithClip(models.generator.parameters(), LR, CLIP)
    d_opt = AdamWithClip(models.disc.parameters(), LR, CLIP)
    steps = optimize.make_optimize_steps(cfg, models, g_opt, d_opt)
    d_before = {k: v.detach().clone() for k, v in models.disc.named_parameters()}
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    batch = to_device({k: v for k, v in _batch().items() if k != "nx"}, torch.device("cpu"))
    aux, d_loss = steps.fused_step(batch, acc, do_apply, gen)
    assert torch.equal(gen.get_state(), before)  # no coins, no dropout: nothing drawn
    assert sorted(aux) == sorted(ref["aux"]) == ["BK", "COPY", "CP", "G", "REC", "STI", "loss"]
    for k, v in ref["aux"].items():
        assert aux[k].item() == pytest.approx(v, rel=1e-5, abs=1e-5), k
    assert d_loss.item() == pytest.approx(ref["d_loss"], rel=1e-5, abs=1e-5)

    g_grads = _clipped(interop.transformer_generator_state_dict_from_jax(ref["g_grads"]))
    for k, p in models.generator.named_parameters():
        _close_rel(p.grad, g_grads[k], 1e-4, f"G grad {k}")
    _check_update(models.generator, interop.transformer_generator_state_dict_from_jax(ref["g"]),
                  g_grads, "G")
    names = [k for k, _ in models.disc.named_parameters()]
    if do_apply:
        assert all(not a.any() for a in acc)
        d_clipped = _clipped(interop.discriminator_state_dict_from_jax(ref["d_grads"]))
        for k, p in models.disc.named_parameters():
            _close_rel(p.grad, d_clipped[k], 1e-4, f"D grad {k}")
        _check_update(models.disc, interop.discriminator_state_dict_from_jax(ref["d"]),
                      d_clipped, "D")
    else:
        want_acc = interop.discriminator_state_dict_from_jax(ref["acc"])
        for k, a in zip(names, acc):
            _close_rel(a, want_acc[k], 1e-4, f"acc {k}")
        for k, p in models.disc.named_parameters():
            assert torch.equal(p.detach(), d_before[k]), k


# ------------------------------------------------------------ configuration
def test_config_flags_and_unknown_backbone():
    cfg = config_from_args(["warmup", "--backbone", "transformer", "--beam_size", "4"][1:])
    assert (cfg.backbone, cfg.beam_size) == ("transformer", 4)
    assert (make_config("yelp").backbone, make_config("yelp").beam_size) == ("lstm", 1)
    with pytest.raises(ValueError, match="backbone"):
        make_config("yelp", backbone="gru")
    bad = make_config("yelp", device="cpu")
    bad.backbone = "gru"
    with pytest.raises(ValueError, match="backbone"):
        build_generator(bad, 20, torch.device("cpu"))


def test_warmup_checkpoint_name():
    assert warmup.warmup_ckpt_name(make_config("yelp")) == "G.pth"
    assert warmup.warmup_ckpt_name(make_config("yelp", backbone="transformer")) \
        == "G_transformer.pth"


def test_build_generator_per_backbone():
    """The LSTM serves in the compute dtype (bf16) and trains in float32; the
    transformer is float32 in both; ``rep_penalty`` reaches the LSTM only."""
    cpu = torch.device("cpu")
    cfg = make_config("yelp", device="cpu", max_len=6, rep_penalty=0.5)
    lstm = build_generator(cfg, 20, cpu)
    assert isinstance(lstm, DenoiseSeq2Seq) and lstm.rep_penalty == 0.5
    assert lstm.fn_2.weight.dtype == torch.bfloat16 and not lstm.training
    cfg.backbone = "transformer"
    for training in (False, True):
        g = build_generator(cfg, 20, cpu, training=training)
        assert isinstance(g, TransformerSeq2Seq) and g.training == training
        assert all(p.dtype == torch.float32 for p in g.parameters())
        assert g.lm_head.out_features == 20 and len(g.enc_layers) == 6


def test_generator_call_dispatch_and_layout():
    """sched with a teacher is the parallel pass and ignores coins; every
    other mode generates over the teacher's length (max_len without one);
    ``time_major_out`` transposes soft outputs only."""
    model = TransformerSeq2Seq(V, 2, L, p_drop=0.0, **PORT_NARROW).eval()
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    x, li = b["x"], b["labels"]
    teacher = generator_call(model, x, li, x, 1 - li, mode="sched",
                             coins=torch.zeros(L, dtype=torch.bool))
    assert torch.equal(teacher, model(x, li, x, 1 - li))
    st = generator_call(model, x, li, None, 1 - li, mode="st", tau=0.5)
    st_tm = generator_call(model, x, li, None, 1 - li, mode="st", tau=0.5, time_major_out=True)
    assert st.shape == (B, L, V) and torch.equal(st_tm, st.transpose(0, 1))
    short = generator_call(model, x, li, x[:, :3], 1 - li, mode="st")
    assert short.shape == (B, 3, V)
    ids = generator_call(model, x, li, None, 1 - li, mode="greedy", time_major_out=True)
    assert ids.shape == (B, L) and ids.dtype == torch.int32
    with pytest.raises(ValueError, match="mode"):
        generator_call(model, x, li, x, 1 - li, mode="teacher")


# ------------------------------------------------------------- through the CLI
def _write_pretrain_dumps(dump: str, Vt: int) -> None:
    """Seeded scorer checkpoints (their values do not matter to the run)."""
    pre = os.path.join(dump, "tiny", "pretrain")
    os.makedirs(pre, exist_ok=True)
    for name, m in (("cls", TextCNN(Vt)), ("mat", PairMatcher(Vt, **PORT_SIZE)),
                    ("dn", TransformerLM(Vt, **PORT_SIZE))):
        torch.save(m.state_dict(), os.path.join(pre, f"{name}.pth"))


def test_cli_warmup_optimize_infer_serve_with_the_transformer(tiny_corpus, tmp_path, capsys):
    """``--backbone transformer --beam_size 4 --device cpu`` at the full
    T5-small widths: warmup writes ``warmup/G_transformer.pth`` (the LSTM's
    ``G.pth`` is not touched), optimize starts from it and keeps a
    ``G_epoch_0.pth`` of the transformer, infer writes the four ``.tsf``
    files with the beam, serve answers every request."""
    flags = ["--dataset", "tiny", "--data_dir", os.path.dirname(tiny_corpus),
             "--dump_dir", str(tmp_path / "dump"), "--log_dir", str(tmp_path / "log"),
             "--out_dir", str(tmp_path / "out"), "--device", "cpu", "--max_len", "6",
             "--batch_size", "4", "--vocab_size", "60", "--dtype", "float32",
             "--backbone", "transformer", "--beam_size", "4",
             *[a for k, v in SCORER.items() for a in (f"--{k}", str(v))]]
    cfg = config_from_args(flags)
    Vt = len(get_tokenizer(cfg))
    _write_pretrain_dumps(str(tmp_path / "dump"), Vt)
    cli.main(["warmup", *flags, "--warmup_batch_size", "4"])
    warm_dir = tmp_path / "dump" / "tiny" / "warmup"
    assert os.listdir(warm_dir) == ["G_transformer.pth"]
    fresh = TransformerSeq2Seq(Vt, 2, 6)
    warm_sd = torch.load(warm_dir / "G_transformer.pth", weights_only=True)
    fresh.load_state_dict(warm_sd, strict=True)
    cli.main(["optimize", *flags, "--epochs", "1"])
    task = tmp_path / "dump" / "tiny" / "optimize-v0"
    assert os.listdir(task) == ["G_epoch_0.pth"]
    fresh.load_state_dict(torch.load(task / "G_epoch_0.pth", weights_only=True), strict=True)
    cli.main(["infer", *flags])
    for split, n in (("train", 6), ("test", 2)):
        for label in (0, 1):
            with open(tmp_path / "out" / "tiny-v0" / f"style.{split}.{label}.tsf") as f:
                assert len(f.read().splitlines()) == n
    capsys.readouterr()
    requests = "0\tthe food was terrible .\n1\tthe staff was great .\nservice was slow .\n"
    import io
    import sys

    old = sys.stdin
    sys.stdin = io.StringIO(requests)
    try:
        cli.main(["serve", *flags])
    finally:
        sys.stdin = old
    assert len(capsys.readouterr().out.splitlines()) == 3
