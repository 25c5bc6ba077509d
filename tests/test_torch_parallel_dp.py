"""Data parallelism of the port's stages (``parallel/sharding.py`` through
``train/*``): two gloo ranks, each on its half of every batch, against one
process on the joined batch, on the CPU in float32 with dropout off and the
sched coins given (ROADMAP's parity rules).

- optimize: 5 ``fused_step``s (D applied at steps 0 and 4, the weighted
  ``w_copy`` term on) leave G, D, both Adams and D's accumulator within
  rtol 1e-5 of one process (the one-process step is the one
  test_torch_optimize_step.py holds against the JAX package's), and the
  logged losses (``global_means`` of the rank means) are one process's;
- the clip sees the global norm: a clip on rank-local norms would differ
  from one process, the port's does not;
- warmup: 3 steps; pretrain: 3 steps, each rank's batch rows (noise draws
  and WMD labels) bit for bit the one-process rows;
- validation over a dev split whose padded last batch gives the ranks 1 and
  0 real rows equals one process's (optimize, warmup and pretrain);
- ``infer`` through the CLI writes ``.tsf`` files byte-equal to one
  process's, greedy and ``--beam_size 2``, and a missing tokenizer dump is
  trained by rank 0 alone;
- the random streams: under two data ranks the coins are equal and the
  dropout masks differ, ranks that differ only in their model index draw
  alike, and a world-size-1 group draws what a run without one draws (3
  optimize steps with dropout on, bit for bit).

The ranks are spawned processes (``spawn``, never ``fork``: this process
holds JAX) that import no JAX and rendezvous on a ``file://`` store. Tensor
tolerances: ``rtol=1e-5`` with ``atol`` 1e-5 of the tensor's largest entry
(Adam's second moments sit near 0, where a relative bound alone means
nothing).
"""

import filecmp
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch import cli  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data import pipeline  # noqa: E402
from consistent__style_transfer_torch.data.corpus import StyleCorpus  # noqa: E402
from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler  # noqa: E402
from consistent__style_transfer_torch.models import (  # noqa: E402
    DenoiseSeq2Seq,
    PairMatcher,
    RelGANDiscriminator,
    TextCNN,
    TransformerLM,
)
from consistent__style_transfer_torch.models.generator import sched_coins  # noqa: E402
from consistent__style_transfer_torch.parallel import mesh as pmesh  # noqa: E402
from consistent__style_transfer_torch.parallel.sharding import (  # noqa: E402
    all_reduce_mean,
    batch_sharding,
    data_group,
    global_means,
    shard_batch,
)
from consistent__style_transfer_torch.text.bpe import BPETokenizer  # noqa: E402
from consistent__style_transfer_torch.text.word2vec import Word2Vec, train_token_w2v  # noqa: E402
from consistent__style_transfer_torch.train.common import rank_generators  # noqa: E402
from consistent__style_transfer_torch.train.loop import validate  # noqa: E402
from consistent__style_transfer_torch.train.optimize import (  # noqa: E402
    gather_streams,
    make_optimize_steps,
    restore_streams,
)
from consistent__style_transfer_torch.train.pretrain import make_pretrain_steps  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402
from consistent__style_transfer_torch.train.warmup import make_warmup_steps  # noqa: E402
from test_torch_parallel import run_ranks  # noqa: E402

L, B = 8, 8  # B: the global training batch, 4 rows a rank
SCORER = dict(n_layers=1, d_model=16, n_heads=2)
CPU = torch.device("cpu")
FLAGS = ["--dataset", "tiny", "--device", "cpu", "--dtype", "float32", "--max_len", str(L),
         "--batch_size", "4", "--vocab_size", "60"]


def _corpus(root: str) -> None:
    """32 train, 9 dev (a last batch of 4 with 1 real row) and 10 test lines."""
    words = {0: "bad awful cold slow rude dirty", 1: "good great warm quick kind clean"}
    os.makedirs(os.path.join(root, "data", "tiny"))
    for split, n in (("train", (16, 16)), ("dev", (5, 4)), ("test", (5, 5))):
        for label in (0, 1):
            w = words[label].split()
            with open(os.path.join(root, "data", "tiny", f"style.{split}.{label}"), "w") as f:
                for i in range(n[label]):
                    print(f"the food was {w[i % 6]} and {w[(i + 2) % 6]} .", file=f)


def _tok_and_w2v(root: str):
    tok = BPETokenizer.load(os.path.join(root, "tok", "tiny-vocab.json"),
                            os.path.join(root, "tok", "tiny-merges.txt"))
    w2v = Word2Vec.load(os.path.join(root, "w2v.npz"))
    w2v.init_sims()
    return tok, w2v


def _files(root, split):
    return [os.path.join(root, "data", "tiny", f"style.{split}.{i}") for i in (0, 1)]


def _opt_models(V, p_drop=0.0):
    return SimpleNamespace(
        generator=DenoiseSeq2Seq(V, 2, L, p_drop=p_drop, seed=1).train(),
        classifier=TextCNN(V, p_drop=p_drop, seed=2),
        matcher=PairMatcher(V, p_drop=p_drop, seed=3, **SCORER),
        nt_checker=TransformerLM(V, p_drop=p_drop, seed=4, **SCORER),
        disc=RelGANDiscriminator(V, p_drop=p_drop, seed=5))


def _state(opts, acc=None) -> dict:
    """{kind/opt.param: tensor}: every parameter of every optimizer, its
    gradient as the last step left it (averaged, clipped), its Adam moments
    and step count; and D's accumulator."""
    out = {}
    for i, opt in enumerate(opts):
        for j, p in enumerate(opt.params):
            out[f"p/{i}.{j}"] = p.detach().clone()
            out[f"grad/{i}.{j}"] = p.grad.clone()
            out.update({f"{k}/{i}.{j}": v.clone() for k, v in opt.adam.state[p].items()})
    out.update({f"acc/{j}": t.clone() for j, t in enumerate(acc or [])})
    return out


def _optimize(root, mesh):
    """5 fused steps on seeded global batches; each rank its rows."""
    tok, _ = _tok_and_w2v(root)
    V = len(tok)
    cfg = make_config("tiny", dtype="float32", max_len=L, device="cpu", w_copy=0.5)
    models = _opt_models(V)
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    group = data_group(mesh)
    g_opt = AdamWithClip(models.generator.parameters(), cfg.optimize_lr, 1.0, group=group)
    d_opt = AdamWithClip(models.disc.parameters(), cfg.optimize_lr, 1.0, group=group)
    weights = np.random.default_rng(7).uniform(0.1, 1.0, V).astype(np.float32)
    steps = make_optimize_steps(cfg, models, g_opt, d_opt, copy_weights=weights, group=group)
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    rng = np.random.default_rng(11)
    losses = []
    for step in range(5):
        batch = {"x": torch.from_numpy(rng.integers(3, V, (B, L))),
                 "labels": torch.from_numpy(rng.integers(0, 2, B))}
        coins = torch.from_numpy(rng.random(L) < 0.5)
        aux, d_loss = steps.fused_step(shard_batch(batch, mesh), acc, step % 4 == 0, coins=coins)
        logged = global_means({"loss": aux["loss"], "D": d_loss}, group)  # what the run logs
        losses.append((logged["loss"].item(), logged["D"].item()))
    return _state([g_opt, d_opt], acc), losses


class _LocalClip(AdamWithClip):
    """The wrong order: each rank clips by its own norm, then averages."""

    def step(self):
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if norm >= self.clip:
            torch._foreach_mul_(grads, self.clip / norm)
        all_reduce_mean(grads, self.group)
        self.adam.step()


def _clip(mesh, local: bool):
    """One clipped step of a linear model on rows whose halves have very
    different gradient norms (rank 0's large, rank 1's small); returns the
    gradients as the step left them (clipped) and the weights."""
    model = torch.nn.Linear(4, 3)
    torch.nn.init.constant_(model.weight, 0.1)
    torch.nn.init.zeros_(model.bias)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32))
    y = torch.cat([torch.full((4, 3), 50.0), torch.full((4, 3), 0.01)])
    opt = (_LocalClip if local else AdamWithClip)(model.parameters(), 0.1, 1.0,
                                                  group=data_group(mesh))
    rows = batch_sharding(mesh, 8)
    opt.zero_grad()
    ((model(x[rows]) - y[rows]) ** 2).mean().backward()
    opt.step()
    return {**{k: v.clone() for k, v in model.state_dict().items()},
            **{f"{k}.grad": p.grad.clone() for k, p in model.named_parameters()}}


def _warmup(root, mesh):
    tok, _ = _tok_and_w2v(root)
    model = DenoiseSeq2Seq(len(tok), 2, L, p_drop=0.0, seed=6)
    opt = AdamWithClip(model.parameters(), 1e-3, 1.0, group=data_group(mesh))
    train_step, _ = make_warmup_steps(model, opt)
    it = pipeline.make_batches(StyleCorpus.from_files(_files(root, "train"), tok, L), B, L,
                               "warmup", shuffle=True, seed=0)
    rng = np.random.default_rng(5)
    for _, batch in zip(range(3), it):
        arrays = {k: torch.from_numpy(v) for k, v in shard_batch(batch.arrays, mesh).items()}
        train_step(arrays, None, coins=torch.from_numpy(rng.random(L) < 0.5))
    return _state([opt])


def _pretrain(root, mesh):
    tok, w2v = _tok_and_w2v(root)
    V = len(tok)
    models = {"cls": TextCNN(V, p_drop=0.0, seed=2),
              "mat": PairMatcher(V, p_drop=0.0, seed=3, **SCORER),
              "dn": TransformerLM(V, p_drop=0.0, seed=4, **SCORER)}
    opt = AdamWithClip([p for m in models.values() for p in m.parameters()], 1e-3, 5.0,
                       group=data_group(mesh))
    train_step, _ = make_pretrain_steps(models, opt)
    rows = None if mesh is None else batch_sharding(mesh, B)
    it = pipeline.make_batches(StyleCorpus.from_files(_files(root, "train"), tok, L), B, L,
                               "pretrain", shuffle=True, seed=0,
                               wmd_labeler=SinkhornWmdLabeler(w2v, tok, max_atoms=L + L // 2),
                               rows=rows)
    batches = []
    for _, batch in zip(range(3), it):
        arrays = {k: torch.as_tensor(v) for k, v in batch.arrays.items()}
        batches.append({k: v.clone() for k, v in arrays.items()})
        train_step(arrays, (True, True, True))
    return _state([opt]), batches


def _validation(root, mesh):
    """The three stages' validations over the 9-line dev split."""
    tok, w2v = _tok_and_w2v(root)
    V = len(tok)
    dev = StyleCorpus.from_files(_files(root, "dev"), tok, L)
    models = _opt_models(V)
    opt = AdamWithClip(models.generator.parameters(), 1e-3, 1.0)
    steps = make_optimize_steps(make_config("tiny", dtype="float32", max_len=L), models, opt,
                                AdamWithClip(models.disc.parameters(), 1e-3, 1.0))
    opt_it = pipeline.make_batches(dev, 4, L, "optimize", shuffle=False)
    out = {"optimize": validate(opt_it, lambda a: [steps.val_step(a)], CPU, mesh)}
    _, warm_eval = make_warmup_steps(models.generator, opt)
    coins = torch.from_numpy(np.random.default_rng(3).random(L) < 0.5)
    warm_it = pipeline.make_batches(dev, 4, L, "warmup", shuffle=False)
    out["warmup"] = validate(warm_it, lambda a: [warm_eval(a, coins)], CPU, mesh)
    towers = {"cls": models.classifier, "mat": models.matcher, "dn": models.nt_checker}
    _, pre_eval = make_pretrain_steps(towers, opt)
    pre_it = pipeline.make_batches(dev, 4, L, "pretrain", shuffle=False,
                                   wmd_labeler=SinkhornWmdLabeler(w2v, tok, max_atoms=L + L // 2),
                                   rows=None if mesh is None else batch_sharding(mesh, 4))
    out["pretrain"] = validate(pre_it, lambda a: list(pre_eval(a, (True, True, True)).values()),
                               CPU, mesh, shard=False)
    out["real_rows"] = [int(pipeline.eval_arrays(b)["row_mask"].sum())
                        if mesh is None else int(shard_batch(pipeline.eval_arrays(b), mesh)
                                                 ["row_mask"].sum())
                        for b in pipeline.make_batches(dev, 4, L, "optimize", shuffle=False)]
    return out


def _infer(root, ver):
    dirs = ["--data_dir", os.path.join(root, "data"), "--dump_dir", os.path.join(root, "dump"),
            "--out_dir", os.path.join(root, "out")]
    cli.main(["infer", *FLAGS, *dirs, "--ver", ver])
    cli.main(["infer", *FLAGS, *dirs, "--ver", f"{ver}_beam", "--beam_size", "2"])


def _streams(mesh):
    gen, coin = rank_generators(0, CPU, mesh)
    return gen.initial_seed(), torch.rand(32, generator=gen), (
        None if coin is None else sched_coins(16, coin, CPU))


def _resume_streams(rank):
    """A full state's ``rank_generators`` gathered from two ranks, each
    rank's streams restored into fresh generators."""
    gens = [torch.Generator().manual_seed(100 * rank + i) for i in range(3)]
    for g in gens:
        torch.rand(5, generator=g)
    state = {"rank_generators": gather_streams(gens)}
    fresh = [torch.Generator() for _ in gens]
    restore_streams(state, *fresh)
    one_rank_state = {"rank_generators": state["rank_generators"][:1]}
    try:
        restore_streams(one_rank_state, *fresh)
        refused = False
    except ValueError:
        refused = True
    return {"restored_own": all(torch.equal(a.get_state(), b.get_state())
                                for a, b in zip(fresh, gens)),
            "entries": len(state["rank_generators"]), "refused_other_world": refused}


def _dp_job(rank, world, store, root):
    """Every two-rank run the tests read, in one group."""
    dp = pmesh.make_mesh(2, 1, "cpu")
    out = {"streams": _streams(dp), "tp_streams": _streams(pmesh.make_mesh(1, 2, "cpu")),
           "validation": _validation(root, dp), "clip": _clip(dp, False),
           "local_clip": _clip(dp, True), "resume": _resume_streams(rank)}
    pretrain_state, out["pretrain_batches"] = _pretrain(root, dp)
    torch.save({"optimize": _optimize(root, dp), "warmup": _warmup(root, dp),
                "pretrain": pretrain_state}, os.path.join(root, f"rank{rank}.pt"))
    _infer(root, "dp")  # the tokenizer dump is missing: rank 0 trains it
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, {rank: results}): the corpus, a tokenizer and a word2vec for
    the training runs, a seeded warmup G in the dump dir, then the two-rank
    job. The dump dir has no tokenizer: rank 0 of the job's ``infer`` trains
    it (the same vocabulary), and the one-process ``infer`` reads it."""
    root = str(tmp_path_factory.mktemp("dp"))
    _corpus(root)
    tok = BPETokenizer.train(_files(root, "train"), 60)
    tok.save(os.path.join(root, "tok"), "tiny")
    train_token_w2v(_files(root, "train"), tok, epochs=2, seed=1, prefer_native=False, dim=16,
                    min_count=1).save(os.path.join(root, "w2v.npz"))
    warm = os.path.join(root, "dump", "tiny", "warmup")
    os.makedirs(warm)
    torch.save(DenoiseSeq2Seq(len(tok), 2, L, seed=3).state_dict(), os.path.join(warm, "G.pth"))
    res = run_ranks(_dp_job, 2, root, root)
    return root, res


def _close(got: dict, want: dict, lr: float, n_steps: int):
    """The gradients, Adam's moments and step counts and D's accumulator
    within rtol 1e-5 (atol 1e-5 of the tensor's largest entry). Parameters
    within rtol 1e-5 plus 1e-3 of Adam's largest move (``lr`` a step): a
    rounding difference in a gradient reaches Adam's normalised step
    m / sqrt(v) amplified where m nearly cancels. Entries whose gradient is
    zero in exact arithmetic (sqrt(v) under 1e-4 of the tensor's largest:
    the key thirds of ``in_proj_bias``, to which softmax is blind) take
    steps of +-lr on rounding noise; they are held within Adam's bound."""
    assert sorted(got) == sorted(want)
    move = lr * n_steps
    for k, w in want.items():
        kind, key = k.split("/")
        if kind != "p":
            atol = 1e-5 * float(w.abs().max()) if w.is_floating_point() and w.numel() else 0.0
            torch.testing.assert_close(got[k], w, rtol=1e-5, atol=atol, msg=k)
            continue
        scale = want[f"exp_avg_sq/{key}"].sqrt()
        noise = scale < 1e-4 * scale.max()
        d = (got[k] - w).abs()
        assert (d[~noise] <= 1e-5 * w.abs()[~noise] + 1e-3 * move).all(), (k, float(d.max()))
        assert (d[noise] <= 2 * move).all(), k


def _rank_state(root, rank):
    return torch.load(os.path.join(root, f"rank{rank}.pt"), weights_only=True)


def test_optimize_two_ranks_equal_one_process(runs):
    root, _ = runs
    want, want_losses = _optimize(root, None)
    for r in (0, 1):
        got, losses = _rank_state(root, r)["optimize"]
        _close(got, want, 1e-5, 5)
        assert np.all(np.isfinite(losses))
        # the logged losses, rank means averaged over the group, are the global batch's
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # the step counts: G every step, D applied at steps 0 and 4 (d_update_every=4)
    assert int(want["step/0.0"]) == 5 and int(want["step/1.0"]) == 2
    assert not any(want[k].any() for k in want if k.startswith("acc/"))


def test_clip_sees_the_global_norm(runs):
    _, res = runs
    want = _clip(None, False)
    for r in (0, 1):
        for k, w in want.items():
            torch.testing.assert_close(res[r]["clip"][k], w, rtol=1e-5, atol=1e-7, msg=k)
        grads = [k for k in want if k.endswith(".grad")]
        norm = float(torch.linalg.vector_norm(torch.cat([want[k].flatten() for k in grads])))
        assert norm == pytest.approx(1.0, rel=1e-5)  # the global gradient was clipped
        gap = max(float((res[r]["local_clip"][k] - want[k]).abs().max()) for k in grads)
        assert gap > 0.1, gap  # clipped rank by rank, the gradient points elsewhere


def test_warmup_two_ranks_equal_one_process(runs):
    root, _ = runs
    want = _warmup(root, None)
    for r in (0, 1):
        _close(_rank_state(root, r)["warmup"], want, 1e-3, 3)


def test_pretrain_two_ranks_equal_one_process(runs):
    """The parameters and Adam after 3 steps; each rank's rows of every
    batch, its WMD labels included, bit for bit the one-process rows."""
    root, res = runs
    want, batches = _pretrain(root, None)
    for r in (0, 1):
        _close(_rank_state(root, r)["pretrain"], want, 1e-3, 3)
        rows = slice(4 * r, 4 * r + 4)
        for got_b, want_b in zip(res[r]["pretrain_batches"], batches):
            for k, v in want_b.items():
                assert torch.equal(got_b[k], v[rows]), k


def test_validation_over_padded_batch_equals_one_process(runs):
    root, res = runs
    want = _validation(root, None)
    assert want["real_rows"] == [4, 4, 1]
    assert [res[0]["validation"]["real_rows"], res[1]["validation"]["real_rows"]] == [
        [2, 2, 1], [2, 2, 0]]
    for r in (0, 1):
        for stage in ("optimize", "warmup", "pretrain"):
            assert res[r]["validation"][stage] == pytest.approx(want[stage], rel=1e-5), stage


def test_infer_two_ranks_byte_equal_one_process(runs):
    root, _ = runs
    _infer(root, "one")
    out = os.path.join(root, "out")
    for dp, one in (("tiny-dp", "tiny-one"), ("tiny-dp_beam", "tiny-one_beam")):
        files = sorted(os.listdir(os.path.join(out, one)))
        assert files == sorted(os.listdir(os.path.join(out, dp))) and len(files) == 4
        for f in files:
            assert filecmp.cmp(os.path.join(out, dp, f), os.path.join(out, one, f),
                               shallow=False), f
    lines = open(os.path.join(out, "tiny-dp", "style.test.0.tsf")).read().splitlines()
    assert len(lines) == 5


def test_coin_and_dropout_streams(runs):
    """Two data ranks: equal coins, different dropout draws, rank 0's
    dropout stream the one-process one; (1, 2): both ranks draw alike."""
    _, res = runs
    (s0, d0, c0), (s1, d1, c1) = res[0]["streams"], res[1]["streams"]
    assert torch.equal(c0, c1) and not torch.equal(d0, d1) and s0 != s1
    seed, draws, coins = _streams(None)
    assert coins is None and s0 == seed and torch.equal(d0, draws)
    (t0, e0, k0), (t1, e1, k1) = res[0]["tp_streams"], res[1]["tp_streams"]
    assert t0 == t1 == seed and torch.equal(e0, e1) and k0 is None and k1 is None


def test_world_size_one_group_draws_what_a_plain_run_draws(tmp_path):
    """3 optimize steps with dropout on and the coins drawn, under a
    world-size-1 gloo group (its all-reduces included) and without one:
    bit for bit the same parameters and Adam states."""
    import torch.distributed as dist

    def run(mesh):
        tok_v = 40
        cfg = make_config("tiny", dtype="float32", max_len=L, device="cpu")
        models = _opt_models(tok_v, p_drop=0.1)
        group = data_group(mesh)
        g_opt = AdamWithClip(models.generator.parameters(), 1e-3, 1.0, group=group)
        d_opt = AdamWithClip(models.disc.parameters(), 1e-3, 1.0, group=group)
        steps = make_optimize_steps(cfg, models, g_opt, d_opt, group=group)
        gen, coin = rank_generators(0, CPU, mesh)
        d_gen, _ = rank_generators(1, CPU, mesh)
        assert coin is None
        acc = [torch.zeros_like(p) for p in models.disc.parameters()]
        rng = np.random.default_rng(2)
        for step in range(3):
            batch = {"x": torch.from_numpy(rng.integers(3, tok_v, (4, L))),
                     "labels": torch.from_numpy(rng.integers(0, 2, 4))}
            steps.fused_step(batch, acc, step % 2 == 0, gen, d_gen, coin_generator=coin)
        return _state([g_opt, d_opt], acc)

    want = run(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(None, 1, "cpu")
        assert mesh is not None and data_group(mesh) is not None
        got = run(mesh)
    finally:
        pmesh.destroy_distributed()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_resume_restores_every_rank_streams(runs):
    """The full state holds both ranks' G, D and coin streams (gathered with
    ``all_gather_object``), each rank restores its own, and a state saved
    by another world size is refused; one process keeps the single-state
    form."""
    _, res = runs
    for r in (0, 1):
        assert res[r]["resume"] == {"restored_own": True, "entries": 2,
                                    "refused_other_world": True}
    assert gather_streams([torch.Generator()]) is None
    gen, d_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    fresh = torch.Generator(), torch.Generator()
    restore_streams({"generator": gen.get_state(), "d_generator": d_gen.get_state()}, *fresh, None)
    assert torch.equal(fresh[0].get_state(), gen.get_state())
    assert torch.equal(fresh[1].get_state(), d_gen.get_state())
    with pytest.raises(ValueError, match="world size"):
        restore_streams({"rank_generators": [[None] * 3] * 2}, *fresh, None)
