"""One optimize ``fused_step`` against the JAX package's, on the CPU in
float32, with the same weights, batch and sched coins: the G-loss aux
(``G``, ``STI``, ``CP``, ``BK``, ``REC``, ``COPY``, ``loss``), ``d_loss``, G's
gradients and update, D's accumulator and update, with ``do_apply`` true and
accumulate only, ``time_major_probs`` on and off, ``fuse_gan_steps`` on and
off. Then the port's own G step: its gradients stay out of D, and its losses
do not depend on the layout.

Dropout is off on both sides: the port's modules are built with ``p_drop=0``;
on the JAX side, ``Config.p_drop=0`` for the generator and, while the JAX
steps are traced, ``flax.linen.Dropout`` is replaced by a module that returns
its input (a test-side patch; the scorers' rates are module constants). The
JAX generator's sched coins are fixed the same way, by replacing
``jax.random.bernoulli`` during the trace. The raw gradients on the JAX side
come from a recording transform chained before the optimizer in the test's
own ``TrainState``. (The rest of the stage is in test_torch_optimize.py.)
"""

from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.config import make_config as jax_make_config  # noqa: E402
from consistent__style_transfer_tpu.train import optimize as jax_optimize  # noqa: E402
from consistent__style_transfer_tpu.train.common import generator_call  # noqa: E402
from consistent__style_transfer_tpu.train.state import TrainState, adam_with_clip  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data.prefetch import to_device  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.train import optimize  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.utils import interop  # noqa: E402

V, B, L = 30, 4, 6
LR, CLIP = 1e-3, 1.0
SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)
COINS = np.array([1, 0, 1, 1, 0, 0], bool)
BOOK_L = 30  # the book preset's max_len (config.py)
BOOK_COINS = np.random.default_rng(3).random(BOOK_L) < 0.5
LOSS_W = dict(w_rec=0.5, w_copy=1.0)  # every branch of the G loss
# (name, time_major_probs, fuse_gan_steps, do_apply); a "book" case runs at
# book's L=30, the rest at L
CASES = [("tm_apply", True, False, True), ("tm_accumulate", True, False, False),
         ("bm_apply", False, False, True), ("tm_fused_accumulate", True, True, False),
         ("book_tm_apply", True, False, True)]


def _max_len(name):
    return BOOK_L if name.startswith("book") else L


def _coins(max_len):
    return COINS if max_len == L else BOOK_COINS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny CPU ops: the test workers share the
    cores, and several torch thread pools spinning on them slow every worker
    many times over."""
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


def _batch(seed=0, max_len=L):
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(3, V, (B, max_len)).astype(np.int32),
            "labels": np.array([0, 1, 1, 0], np.int32)}


def _copy_weights():
    return np.random.default_rng(9).uniform(0.1, 1.0, V).astype(np.float32)


def _jax_cfg(tm, fuse, max_len=L):
    return jax_make_config("tiny", dtype="float32", max_len=max_len, p_drop=0.0,
                           time_major_probs=tm, fuse_gan_steps=fuse, **LOSS_W, **SCORER)


@pytest.fixture(scope="module")
def jax_ref():
    """Initial params of the five JAX models and the JAX results of every
    case, traced and run with dropout off and the coins fixed."""
    models = jax_optimize.OptimizeModels(_jax_cfg(True, False), V)
    kc, km, kn, kg, kd = jax.random.split(jax.random.PRNGKey(0), 5)
    x0, l0 = jnp.zeros((2, L), jnp.int32), jnp.zeros((2,), jnp.int32)
    n0 = jnp.zeros((2, L + L // 2), jnp.int32)
    frozen = {"cls": models.classifier.init(kc, x0), "mat": models.matcher.init(km, n0, n0),
              "nt": models.nt_checker.init(kn, x0)}
    g_params = models.generator.init(kg, x0, l0, None, l0, deterministic=True)
    d_params = models.disc.init(kd, x0)
    key = jax.random.PRNGKey(5)
    out = {"frozen": _np(frozen), "g": _np(g_params), "d": _np(d_params)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        mp.setattr(jax.random, "bernoulli",
                   lambda k, p, shape: jnp.asarray(_coins(shape[0])[: shape[0]]))
        for name, tm, fuse, do_apply in CASES:
            max_len = _max_len(name)
            batch = {k: jnp.asarray(v) for k, v in _batch(max_len=max_len).items()}
            # the parameters do not depend on max_len; the modules decode it
            case_models = (models if max_len == L
                           else jax_optimize.OptimizeModels(_jax_cfg(tm, fuse, max_len), V))
            steps = jax_optimize.make_optimize_steps(_jax_cfg(tm, fuse, max_len), case_models,
                                                     copy_weights=_copy_weights())
            tx = optax.chain(_record(), adam_with_clip(LR, CLIP))
            g_state, d_state = TrainState.create(g_params, tx), TrainState.create(d_params, tx)
            acc = jax.tree.map(jnp.zeros_like, d_params)
            g_state, d_state, acc, aux, d_loss = steps.fused_step(
                g_state, d_state, acc, frozen, batch, key, jax.random.fold_in(key, 1), 0,
                do_apply=do_apply)
            out[name] = {"aux": {k: float(v) for k, v in aux.items()}, "d_loss": float(d_loss),
                         "g_grads": _np(g_state.opt_state[0]), "g": _np(g_state.params),
                         "d_grads": _np(d_state.opt_state[0]), "d": _np(d_state.params),
                         "acc": _np(acc)}
            if max_len != L:
                # D's gradients on one fake decode that both packages get:
                # the JAX package's st decode of its updated G, as its D step
                # decodes it (time-major with time_major_probs)
                fake = generator_call(case_models.generator, g_state.params, batch["x"],
                                      batch["labels"], None, 1 - batch["labels"], mode="st",
                                      tau=_jax_cfg(tm, fuse, max_len).tau, deterministic=False,
                                      rngs={"dropout": key, "coin": key}, time_major_out=tm)
                grads, loss = steps.d_grads_reuse(d_params, fake, batch, {"dropout": key})
                out[name]["same_fake"] = {"fake": np.array(fake), "d_grads": _np(grads),
                                          "d_loss": float(loss)}
    return out


def _port_models(ref, tm=True, fuse=False, max_len=L):
    """The port's five modules holding the JAX params, without dropout, the
    scorers frozen, and a config to match."""
    cfg = make_config("tiny", dtype="float32", max_len=max_len, p_drop=0.0, device="cpu",
                      time_major_probs=tm, fuse_gan_steps=fuse, optimize_lr=LR,
                      optimize_clip=CLIP, **LOSS_W, **SCORER)
    models = SimpleNamespace(
        generator=DenoiseSeq2Seq(V, 2, max_len, p_drop=0.0), classifier=TextCNN(V, p_drop=0.0),
        matcher=PairMatcher(V, p_drop=0.0, **PORT_SIZE),
        nt_checker=TransformerLM(V, p_drop=0.0, **PORT_SIZE), disc=RelGANDiscriminator(V, p_drop=0.0))
    models.generator.load_state_dict(interop.generator_state_dict_from_jax(ref["g"]), strict=True)
    models.disc.load_state_dict(interop.discriminator_state_dict_from_jax(ref["d"]), strict=True)
    for m, key, to_sd in ((models.classifier, "cls", interop.classifier_state_dict_from_jax),
                          (models.matcher, "mat", interop.matcher_state_dict_from_jax),
                          (models.nt_checker, "nt", interop.lm_state_dict_from_jax)):
        m.load_state_dict(to_sd(ref["frozen"][key]), strict=True)
        m.requires_grad_(False)
    return cfg, models


def _steps(cfg, models):
    g_opt = AdamWithClip(models.generator.parameters(), LR, CLIP)
    d_opt = AdamWithClip(models.disc.parameters(), LR, CLIP)
    return optimize.make_optimize_steps(cfg, models, g_opt, d_opt, copy_weights=_copy_weights())


def _close_rel(got, want, rel, msg):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-10, f"{msg}: max abs err {err} vs {rel} x {scale}"


def _clipped(grads: dict) -> dict:
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    return {k: g * min(1.0, CLIP / norm) for k, g in grads.items()}


def _check_update(module, before, after_jax, grads, msg):
    """Adam's first step, lr * g / (|g| + 1e-8): within 1e-6 where |g| is
    above 1e-4 (there a gradient 1e-4 off moves the step by under 1e-8);
    elsewhere within 2 lr (a near-zero entry may take either sign's step in
    the two frameworks)."""
    for k, p in module.named_parameters():
        diff = (p.detach() - after_jax[k]).abs()
        g = grads[k].abs()
        big = g > 1e-4
        if big.any():
            assert float(diff[big].amax()) <= 1e-6, f"{msg} {k}"
        assert float(diff.max()) <= 2 * LR + 1e-6, f"{msg} {k}"
        if before is not None:
            assert not torch.equal(p.detach(), before[k]) or not g.any(), f"{msg} {k} did not move"


@pytest.mark.parametrize("name,tm,fuse,do_apply", CASES, ids=[c[0] for c in CASES])
def test_fused_step_matches_jax(jax_ref, name, tm, fuse, do_apply):
    """Aux losses and d_loss within 1e-5; G's gradients (clipped) and D's
    accumulator within 1e-4 of each parameter's largest entry; the updated G
    and D as in ``_check_update``; with accumulate only, D unchanged and
    the accumulator the step's D gradients. The book case runs at L=30,
    where D's max-pool over time makes its gradients ill-conditioned in the
    fake input: on the soft decode of this untrained G the windows'
    activations nearly tie, and a change of 3.4e-8 in the fake (the two
    frameworks' decodes differ by that much) moves D's embedding gradient
    by 6.7e-4 of its largest entry, in the port alone. So there D's
    gradients and loss are held, to the same tolerances, on one fake decode
    that both packages get (the JAX package's), and the fused step's D
    update as in ``_check_update``."""
    ref = jax_ref[name]
    max_len = _max_len(name)
    cfg, models = _port_models(jax_ref, tm, fuse, max_len)
    steps = _steps(cfg, models)
    names = [k for k, _ in models.disc.named_parameters()]
    if max_len != L:
        same = ref["same_fake"]
        batch = to_device(_batch(max_len=max_len), torch.device("cpu"))
        grads, loss = steps.d_grads_reuse(torch.from_numpy(same["fake"]), batch)
        assert loss.item() == pytest.approx(same["d_loss"], rel=1e-5, abs=1e-5)
        want = interop.discriminator_state_dict_from_jax(same["d_grads"])
        for k, g in zip(names, grads):
            _close_rel(g, want[k], 1e-4, f"D grad on the same fake {k}")
    d_before = {k: v.detach().clone() for k, v in models.disc.named_parameters()}
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    aux, d_loss = steps.fused_step(to_device(_batch(max_len=max_len), torch.device("cpu")), acc,
                                   do_apply, coins=torch.from_numpy(_coins(max_len)))
    assert sorted(aux) == sorted(ref["aux"]) == ["BK", "COPY", "CP", "G", "REC", "STI", "loss"]
    for k, v in ref["aux"].items():
        assert aux[k].item() == pytest.approx(v, rel=1e-5, abs=1e-5), k
    assert d_loss.item() == pytest.approx(ref["d_loss"], rel=1e-5, abs=1e-5)

    g_grads = _clipped(interop.generator_state_dict_from_jax(ref["g_grads"]))
    for k, p in models.generator.named_parameters():
        _close_rel(p.grad, g_grads[k], 1e-4, f"G grad {k}")
    _check_update(models.generator, None, interop.generator_state_dict_from_jax(ref["g"]),
                  g_grads, "G")

    got_acc = dict(zip(names, acc))
    want_acc = interop.discriminator_state_dict_from_jax(ref["acc"])
    d_grads = interop.discriminator_state_dict_from_jax(ref["d_grads"])
    if do_apply:
        assert all(not a.any() for a in acc) and all(not a.any() for a in want_acc.values())
        d_clipped = _clipped(d_grads)
        for k, p in models.disc.named_parameters():
            if max_len == L:  # at L=30 held above, on the same fake
                _close_rel(p.grad, d_clipped[k], 1e-4, f"D grad {k}")
        _check_update(models.disc, d_before, interop.discriminator_state_dict_from_jax(ref["d"]),
                      d_clipped, "D")
    else:
        for k in names:
            _close_rel(got_acc[k], want_acc[k], 1e-4, f"acc {k}")
            assert torch.equal(dict(models.disc.named_parameters())[k].detach(), d_before[k])
        assert any(a.any() for a in acc)


def test_time_major_probs_is_layout_invariant_in_the_port(jax_ref):
    """The port's own G loss with time_major_probs on and off: the same aux
    within 1e-6 and the same G gradients within 1e-5 of their largest entry."""
    results = []
    for tm in (True, False):
        cfg, models = _port_models(jax_ref, tm)
        total, aux, sample_p = _steps(cfg, models).g_loss_fn(
            to_device(_batch(), torch.device("cpu")), coins=torch.from_numpy(COINS))
        assert sample_p.shape == ((L, B, V) if tm else (B, L, V))
        total.backward()
        results.append((aux, {k: p.grad.clone() for k, p in models.generator.named_parameters()}))
    (a_tm, g_tm), (a_bm, g_bm) = results
    for k in a_tm:
        assert a_tm[k].item() == pytest.approx(a_bm[k].item(), abs=1e-6), k
    for k in g_tm:
        _close_rel(g_tm[k], g_bm[k], 1e-5, k)


def test_g_step_leaves_d_gradients_alone(jax_ref):
    """The G loss back-propagates through D, but only G's parameters take
    the gradient: D's .grad stays as it was, so no stray gradient reaches
    its accumulator; D's parameters do not move."""
    cfg, models = _port_models(jax_ref)
    steps = _steps(cfg, models)
    for p in models.disc.parameters():
        p.grad.fill_(0.25)
    before = {k: v.detach().clone() for k, v in models.disc.named_parameters()}
    aux, fake = steps.g_step(to_device(_batch(), torch.device("cpu")),
                             coins=torch.from_numpy(COINS))
    assert not fake.requires_grad and torch.isfinite(aux["loss"])
    for k, p in models.disc.named_parameters():
        assert torch.equal(p.grad, torch.full_like(p, 0.25)), k
        assert torch.equal(p.detach(), before[k]), k
    assert all(p.grad.any() for p in models.generator.parameters())
