"""The LFM2-8B-A1B backbone (``--backbone lfm2_moe``) against its plain
float32 reference (``tests/plain_lfm2_moe.py``) on seeded random weights,
on the CPU in float32, at a small size: d=64, 4 heads / 2 KV heads of 16,
8 experts of width 32, top 4, the first 4 of the published layer types
(conv with the dense FFN, conv, attention, conv, the last three with
experts; one dense layer here).

Tolerances: the port and the reference run the same float32 equations in
another order (the port's cached decode, grouped rows and fused chunks
against the reference's full recompute and per-expert rows), so they
differ by float32 round-off, about 1e-6 of a value's scale. Each check
allows 1e-4 of the compared tensor's largest entry: bfloat16 products
(8 bits of mantissa, a relative error of about 4e-3 a product) miss it by
an order of magnitude, which :func:`test_the_tolerance_fails_bfloat16`
shows for the logits.
"""

import io
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_torch import cli  # noqa: E402
from consistent__style_transfer_torch.config import config_from_args, make_config  # noqa: E402
from consistent__style_transfer_torch.models import lfm2_moe, moe  # noqa: E402
from consistent__style_transfer_torch.models.beam import beam_decode_any  # noqa: E402
from consistent__style_transfer_torch.models.lfm2_moe import (  # noqa: E402
    Lfm2MoeGenerator,
    generate,
)
from consistent__style_transfer_torch.models.weight_cast import WeightCast  # noqa: E402
from consistent__style_transfer_torch.train.common import (  # noqa: E402
    build_generator,
    get_tokenizer,
)
from consistent__style_transfer_torch.train.warmup import warmup_ckpt_name  # noqa: E402
from consistent__style_transfer_torch.utils import profiling  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from plain_lfm2_moe import PlainLfm2Moe  # noqa: E402

V, B, L, N_LAYERS = 40, 3, 5, 4
NARROW = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, d_expert=32,
              n_experts=8, top_k=4, n_dense=1)
REL = 1e-4  # of the compared tensor's largest entry (module note)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(p_drop=0.0, seed=3):
    port = Lfm2MoeGenerator(V, 2, L, p_drop=p_drop, seed=seed, n_layers=N_LAYERS, **NARROW)
    w = NARROW
    ref = PlainLfm2Moe(V, 2, N_LAYERS, w["d_model"], w["n_heads"], w["n_kv_heads"],
                       w["head_dim"], w["d_ff"], w["d_expert"], w["n_experts"], w["top_k"],
                       w["n_dense"], p_drop=p_drop)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, V, (B, L), generator=g)
    labels = torch.tensor([0, 1, 0])
    return x, labels


def _close(a, b, rel=REL):
    scale = b.abs().max().item()
    gap = (a - b).abs().max().item()
    assert gap <= rel * scale, f"gap {gap:.3g} over {rel:g} of {scale:.3g}"


def test_teacher_forced_logits_match_the_reference():
    """The ``sched`` pass with a teacher, in train mode: dropout on the
    embedded inputs, masks drawn from generators seeded alike."""
    port, ref = _models(p_drop=0.1)
    x, labels = _batch()
    got = port(x, labels, x, 1 - labels, generator=torch.Generator().manual_seed(5))
    want = ref(x, labels, x, 1 - labels, generator=torch.Generator().manual_seed(5))
    assert got.shape == (B, L, V)
    _close(got, want)


def test_the_tolerance_fails_bfloat16():
    """The same pass with bfloat16 products (autocast) misses REL."""
    port, ref = _models()
    x, labels = _batch()
    want = ref(x, labels, x, 1 - labels)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = port(x, labels, x, 1 - labels).float()
    assert (got - want).abs().max().item() > 10 * REL * want.abs().max().item()


@pytest.mark.parametrize("mode", ["greedy", "sched", "st"])
def test_cached_decodes_match_the_full_forward(mode):
    """The cached decode (KV cache and conv state) against the reference's
    full pass over the prefix at every step; ``st`` in train mode, with
    dropout, the rest in eval mode. Greedy ids are equal."""
    training = mode == "st"
    port, ref = _models(p_drop=0.1 if training else 0.0)
    port.train(training)
    ref.train(training)
    x, labels = _batch(1)
    got = generate(port, x, labels, 1 - labels, mode=mode, tau=0.5,
                   generator=torch.Generator().manual_seed(9))
    want = ref.decode(x, labels, 1 - labels, L, mode=mode, tau=0.5,
                      generator=torch.Generator().manual_seed(9))
    if mode == "greedy":
        assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    else:
        _close(got, want)


def test_generator_gradients_of_an_optimize_step():
    """G's gradients of the optimize step's generator terms: a score of
    the straight-through transfer (the scorers' and D's part, here a fixed
    random projection of the probs) plus the back-translation CE of the
    teacher-forced pass on its argmax, in train mode with dropout."""
    port, ref = _models(p_drop=0.1)
    port.train()
    ref.train()
    x, labels = _batch(2)
    proj = torch.randn(B, L, V, generator=torch.Generator().manual_seed(4))

    def loss(model, call):
        gen = torch.Generator().manual_seed(11)
        probs = call(model, "st", gen)
        logits = model(probs.detach().argmax(-1), 1 - labels, x, labels, generator=gen)
        ce = torch.nn.functional.cross_entropy(logits.reshape(-1, V), x.reshape(-1))
        return (probs * proj).sum() + ce

    def port_call(model, mode, gen):
        return model(x, labels, None, 1 - labels, mode=mode, tau=0.1, generator=gen)

    def ref_call(model, mode, gen):
        return model.decode(x, labels, 1 - labels, L, mode=mode, tau=0.1, generator=gen)

    loss(port, port_call).backward()
    loss(ref, ref_call).backward()
    ref_grads = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        _close(p.grad, ref_grads[name].grad)


def _moe_layer(seed=0, d=64, E=8, k=4, F=32):
    layer = moe.SparseMoE(d, F, E, k)
    layer.reset_parameters_from(torch.Generator().manual_seed(seed))
    return layer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_dispatch_matches_the_per_expert_loop(dtype, monkeypatch):
    """Sorted rows, device offsets, grouped products and the combine
    (float32: the row-range loop; bfloat16: ``torch._grouped_mm``, which
    runs on the CPU too) against the reference's experts, each on its own
    rows. The selection is the float32 router's in both (a bfloat16 router
    may pick another expert at a near-tie); in bfloat16 the tolerance is
    bfloat16's: 2e-2, five of its relative steps."""
    layer = _moe_layer()
    _, ref = _models()
    ffn = ref.layers[1].feed_forward
    with torch.no_grad():
        for name in ("w1", "w3", "w2"):
            getattr(ffn, name).copy_(getattr(layer, name))
        ffn.router.weight.copy_(layer.router.weight)
    x = torch.randn(37, 64, generator=torch.Generator().manual_seed(1))
    fixed = layer.router(x, None)
    monkeypatch.setattr(layer.router, "forward", lambda x, cast: fixed)
    cast = (None if dtype == torch.float32
            else WeightCast(list(layer.parameters()), dtype, "test.weight_casts"))
    got = layer(x, cast).float()
    want = ref.experts(ffn, x)
    _close(got, want, REL if dtype == torch.float32 else 2e-2)
    assert int(layer.load.sum()) == 37 * 4  # the routed rows, per expert


def test_the_combine_is_deterministic_and_keeps_every_slot():
    """Two calls give the same bits, forward and backward; every routed row
    comes back to its own slot (an expert whose output is its row index
    gives each token the gate-weighted sum of its own index)."""
    layer = _moe_layer(1)
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(2), requires_grad=True)
    runs = []
    for _ in range(2):
        out = layer(x, None)
        grad, = torch.autograd.grad(out.square().sum(), x)
        runs.append((out, grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])

    gates, experts = layer.router(x.detach(), None)
    original = moe.grouped_swiglu
    try:
        moe.grouped_swiglu = lambda xs, ends, *w: xs[:, :1].expand(-1, 64)
        mark = x.detach().clone()
        mark[:, 0] = torch.arange(50, dtype=torch.float32)
        out = layer(mark, None)
    finally:
        moe.grouped_swiglu = original
    assert torch.allclose(out[:, 0], torch.arange(50.0) * gates.sum(-1), atol=1e-5)


def test_generation_api_and_config():
    """``--backbone lfm2_moe`` and ``--lfm2_layers``: the warmup checkpoint
    name, the generator built (float32 masters for training, the compute
    dtype for serving), the first N layer types."""
    cfg = config_from_args(["--backbone", "lfm2_moe", "--lfm2_layers", "3", "--device", "cpu"])
    assert cfg.backbone == "lfm2_moe" and cfg.lfm2_layers == 3
    assert warmup_ckpt_name(cfg) == "G_lfm2_moe.pth"
    with pytest.raises(ValueError):
        make_config("yelp", backbone="lfm2")
    old = dict(lfm2_moe.PUBLISHED)
    lfm2_moe.PUBLISHED.update(NARROW)
    try:
        g = build_generator(cfg, V, torch.device("cpu"), training=True)
        s = build_generator(cfg, V, torch.device("cpu"))
    finally:
        lfm2_moe.PUBLISHED.clear()
        lfm2_moe.PUBLISHED.update(old)
    assert isinstance(g, Lfm2MoeGenerator) and g.training and not s.training
    assert [type(layer.mixer).__name__ for layer in g.layers] == [
        "ShortConv", "ShortConv", "GQAttention"]
    assert g.token_embedding.weight.dtype == torch.float32
    assert s.token_embedding.weight.dtype == torch.bfloat16
    x, labels = _batch()
    ids, scores = beam_decode_any(s, x, labels, 1 - labels, beam_size=2)
    assert ids.shape == (B, cfg.max_len) and scores.shape == (B,)


def test_checkpointed_layers_count_each_routed_row_once():
    """With gradients every layer is checkpointed and runs again in the
    backward; the recomputation adds nothing to ``load``."""
    port, _ = _models()
    x, labels = _batch()
    port(x, labels, x, 1 - labels).sum().backward()
    loads = [int(m.load.sum()) for m in port.modules() if isinstance(m, moe.SparseMoE)]
    assert loads == [B * 2 * L * 4] * 3


def test_spans_and_counters_of_an_eager_call(monkeypatch):
    """An eager call records ``moe.route``, ``moe.dispatch``,
    ``moe.experts``, ``moe.combine`` and the counter ``moe.rows``."""
    monkeypatch.setattr(profiling.RECORDER, "env", True)
    profiling.RECORDER.clear()
    try:
        _moe_layer()(torch.randn(6, 64), None)
        names = [s[0] for s in profiling.RECORDER.spans]
        rows = [(n, v) for n, _, v in profiling.RECORDER.counters]
    finally:
        profiling.RECORDER.clear()
    assert names == ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert rows == [("moe.rows", 24)]


def test_count_step_is_kept_with_a_capture(monkeypatch):
    """While a ``kept_counts`` scope's stream captures, ``count_step`` goes
    to the scope's sums (replayed by ``GraphedStep``), not to the totals or
    the counters."""
    monkeypatch.setattr(profiling.RECORDER, "env", True)
    monkeypatch.setattr(profiling, "capturing_stream", lambda: 7)
    profiling.RECORDER.clear()
    before = profiling.total("moe.rows")
    try:
        with profiling.kept_counts(7) as kept:
            profiling.count_step("moe.rows", 12)
            profiling.count_step("moe.rows", 3)
        counters = list(profiling.RECORDER.counters)
    finally:
        profiling.RECORDER.clear()
    assert dict(kept) == {"moe.rows": 15} and not counters
    assert profiling.total("moe.rows") == before


def test_cli_warmup_optimize_infer_serve(tiny_corpus, tmp_path, capsys):
    """``--backbone lfm2_moe --lfm2_layers 4 --device cpu`` (the widths
    narrowed by setting ``PUBLISHED`` for the test): warmup writes
    ``warmup/G_lfm2_moe.pth``, optimize starts from it in train mode and
    keeps a ``G_epoch_0.pth``, optimize in test mode and infer write the
    ``.tsf`` files, serve answers every request greedily and with a beam
    of 2."""
    from test_torch_backbone import SCORER, _write_pretrain_dumps

    flags = ["--dataset", "tiny", "--data_dir", os.path.dirname(tiny_corpus),
             "--dump_dir", str(tmp_path / "dump"), "--log_dir", str(tmp_path / "log"),
             "--out_dir", str(tmp_path / "out"), "--device", "cpu", "--max_len", "6",
             "--batch_size", "4", "--vocab_size", "60", "--dtype", "float32",
             "--backbone", "lfm2_moe", "--lfm2_layers", "4",
             *[a for k, v in SCORER.items() for a in (f"--{k}", str(v))]]
    old = dict(lfm2_moe.PUBLISHED)
    lfm2_moe.PUBLISHED.update(NARROW)
    try:
        Vt = len(get_tokenizer(config_from_args(flags)))
        _write_pretrain_dumps(str(tmp_path / "dump"), Vt)
        cli.main(["warmup", *flags, "--warmup_batch_size", "4"])
        warm_dir = tmp_path / "dump" / "tiny" / "warmup"
        assert os.listdir(warm_dir) == ["G_lfm2_moe.pth"]
        fresh = Lfm2MoeGenerator(Vt, 2, 6, n_layers=4)
        fresh.load_state_dict(torch.load(warm_dir / "G_lfm2_moe.pth", weights_only=True),
                              strict=True)
        cli.main(["optimize", *flags, "--epochs", "1"])
        task = tmp_path / "dump" / "tiny" / "optimize-v0"
        assert os.listdir(task) == ["G_epoch_0.pth"]
        fresh.load_state_dict(torch.load(task / "G_epoch_0.pth", weights_only=True),
                              strict=True)
        cli.main(["optimize", *flags, "--mode", "test"])
        cli.main(["infer", *flags])
        for split, n in (("train", 6), ("test", 2)):
            for label in (0, 1):
                with open(tmp_path / "out" / "tiny-v0" / f"style.{split}.{label}.tsf") as f:
                    assert len(f.read().splitlines()) == n
        requests = "0\tthe food was terrible .\n1\tthe staff was great .\nservice was slow .\n"
        for beam in ("1", "2"):
            capsys.readouterr()
            old_stdin, sys.stdin = sys.stdin, io.StringIO(requests)
            try:
                cli.main(["serve", *flags, "--beam_size", beam])
            finally:
                sys.stdin = old_stdin
            assert len(capsys.readouterr().out.splitlines()) == 3
    finally:
        lfm2_moe.PUBLISHED.clear()
        lfm2_moe.PUBLISHED.update(old)
