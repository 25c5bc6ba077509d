"""The port's beam decode (``models/beam.py``, ``models/generator.py::
stateful_beam_decode``) against the JAX package's ``beam_decode_any`` on the
same weights, on the CPU in float32: the LSTM's stateful beam and the
transformer's prefix-rescoring beam give the same ids and scores within
1e-5; beam 1 is greedy; the scores are the teacher-forced log-probs of the
returned ids over L ** 0.6; the search keeps the beams a plain list-based
search keeps; the transfer step of ``serve`` and ``infer`` takes the
beam with ``beam_size`` > 1, through the runner that replays it as a CUDA
graph on the card, with the JAX package's ids and scores.

The narrow JAX transformer is made as in test_torch_seq2seq_transformer.py
(its width constants set for this file's duration, a test-side patch).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import consistent__style_transfer_tpu.models.seq2seq_transformer as jax_tf  # noqa: E402
from consistent__style_transfer_tpu.models import DenoiseSeq2Seq as JaxSeq2Seq  # noqa: E402
from consistent__style_transfer_tpu.models.beam import beam_decode_any as jax_beam  # noqa: E402
from consistent__style_transfer_torch.models.beam import beam_decode_any, beam_search  # noqa: E402
from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq  # noqa: E402
from consistent__style_transfer_torch.models.seq2seq_transformer import (  # noqa: E402
    TransformerSeq2Seq,
    generate,
)
from consistent__style_transfer_torch.train.infer import make_transfer_step  # noqa: E402
from consistent__style_transfer_torch.utils.interop import (  # noqa: E402
    generator_state_dict_from_jax,
    transformer_generator_state_dict_from_jax,
)

V, B, L = 40, 3, 5
NARROW = dict(D_MODEL=32, N_HEADS=4, HEAD_DIM=8, N_ENC=2, N_DEC=2, D_FF=64)
PORT_NARROW = dict(d_model=32, n_heads=4, n_enc=2, n_dec=2, d_ff=64)
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, V, (B, L)).astype(np.int32), np.array([0, 1, 1], np.int32)


@pytest.fixture(scope="module")
def models():
    """{backbone: (JAX model, params, the port's model in eval mode)}, the
    JAX transformer narrowed for the file."""
    x, li = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in NARROW.items():
            mp.setattr(jax_tf, k, v)
        out = {}
        jm = JaxSeq2Seq(n_vocab=V, n_class=2, max_len=L)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x, li, None, li,
                                                  deterministic=True))
        pm = DenoiseSeq2Seq(V, 2, L).eval()
        pm.load_state_dict(generator_state_dict_from_jax(params), strict=True)
        out["lstm"] = (jm, params, pm)
        jm = jax_tf.TransformerSeq2Seq(n_vocab=V, n_class=2, max_len=L, p_drop=0.0)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x, li, None, li,
                                                  deterministic=True))
        pm = TransformerSeq2Seq(V, 2, L, p_drop=0.0, **PORT_NARROW).eval()
        pm.load_state_dict(transformer_generator_state_dict_from_jax(params), strict=True)
        out["transformer"] = (jm, params, pm)
        yield out


def _greedy(pm, x, li):
    if isinstance(pm, TransformerSeq2Seq):
        return generate(pm, x, li, 1 - li, mode="greedy")
    with torch.no_grad():
        return pm(x, li, None, 1 - li, mode="greedy")


def _teacher_logits(pm, x, li, ids):
    with torch.no_grad():
        if isinstance(pm, TransformerSeq2Seq):
            return pm(x, li, ids, 1 - li)
        return pm(x, li, ids, 1 - li, mode="teacher")


@pytest.mark.parametrize("backbone,K", [("lstm", 4), ("lstm", 3), ("transformer", 4),
                                        ("transformer", 2)])
def test_beam_matches_jax(models, backbone, K):
    """Ids equal, scores within 1e-5 (absolute; they are about -1 to -10)."""
    jm, params, pm = models[backbone]
    x, li = _inputs(1)
    want_ids, want_scores = jax_beam(jm, params, x, li, 1 - li, beam_size=K)
    ids, scores = beam_decode_any(pm, torch.tensor(x), torch.tensor(li),
                                  torch.tensor(1 - li), beam_size=K)
    assert ids.dtype == torch.int32 and ids.shape == (B, L) and scores.shape == (B,)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=0,
                               atol=SCORE_TOL)


@pytest.mark.parametrize("backbone", ["lstm", "transformer"])
def test_beam_1_is_greedy(models, backbone):
    _, _, pm = models[backbone]
    x, li = (torch.tensor(a) for a in _inputs(2))
    ids, scores = beam_decode_any(pm, x, li, 1 - li, beam_size=1)
    assert torch.equal(ids, _greedy(pm, x, li))
    assert torch.isfinite(scores).all()


@pytest.mark.parametrize("backbone", ["lstm", "transformer"])
def test_scores_are_teacher_forced_logprobs(models, backbone):
    """A beam's score is the sum of its ids' teacher-forced log-probs over
    L ** 0.6 (1e-5), and beam 4 scores at least as high as greedy."""
    _, _, pm = models[backbone]
    x, li = (torch.tensor(a) for a in _inputs(3))
    ids, scores = beam_decode_any(pm, x, li, 1 - li, beam_size=4)
    logp = torch.log_softmax(_teacher_logits(pm, x, li, ids), -1)
    true = logp.gather(-1, ids.long()[..., None])[..., 0].sum(-1) / L ** 0.6
    torch.testing.assert_close(scores, true, rtol=0, atol=SCORE_TOL)
    greedy = _greedy(pm, x, li)
    g_logp = torch.log_softmax(_teacher_logits(pm, x, li, greedy), -1)
    g_score = g_logp.gather(-1, greedy.long()[..., None])[..., 0].sum(-1) / L ** 0.6
    assert bool((scores >= g_score - SCORE_TOL).all())


def test_transformer_beam_decode_is_the_prefix_beam(models):
    """The transformer's beam is :func:`beam_search` over its own
    teacher-forced log-probs of each prefix."""
    _, _, pm = models["transformer"]
    x, li = (torch.tensor(a) for a in _inputs(4))
    K = 3

    def next_logp(prefix, t, expanded):
        rows = (x.repeat_interleave(K, 0), li.repeat_interleave(K, 0)) if expanded else (x, li)
        logits = pm.teacher_pass(rows[0], rows[1], prefix, 1 - rows[1])
        return torch.log_softmax(logits[:, t].float(), dim=-1)

    a = beam_search(next_logp, B, L, V, K, 0.6)
    b = beam_decode_any(pm, x, li, 1 - li, beam_size=K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("backbone", ["lstm", "transformer"])
def test_transfer_step_takes_the_beam(models, backbone):
    """``make_transfer_step(model, beam_size)``: beam ids with K > 1, greedy
    ids with 1; each decodes to the opposite style."""
    _, _, pm = models[backbone]
    x, li = (torch.tensor(a) for a in _inputs(5))
    ids, _ = beam_decode_any(pm, x, li, 1 - li, beam_size=4)
    assert torch.equal(make_transfer_step(pm, 4)(x, li), ids)
    assert torch.equal(make_transfer_step(pm)(x, li), _greedy(pm, x, li))


@pytest.mark.parametrize("backbone,K", [("lstm", 4), ("transformer", 3)])
def test_transfer_step_beam_matches_jax(models, backbone, K):
    """The beam through ``make_transfer_step(model, K)``'s runner (a CUDA
    graph per input shape on the card, the same function eagerly here):
    ids equal the JAX package's ``beam_decode_any``, scores within 1e-5;
    the step returns the runner's ids."""
    jm, params, pm = models[backbone]
    x, li = _inputs(6)
    want_ids, want_scores = jax_beam(jm, params, x, li, 1 - li, beam_size=K)
    step = make_transfer_step(pm, K)
    ids, scores = step.runner({"x": torch.tensor(x), "labels": torch.tensor(li)}, (B, L))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=0, atol=SCORE_TOL)
    assert torch.equal(step(torch.tensor(x), torch.tensor(li)), ids)


def test_beam_search_bookkeeping_against_a_plain_search():
    """``beam_search`` against a plain list-based beam search of the same
    rule (step 0 keeps the top K tokens; each later step the top K of the
    K * V extensions; the best by score / L ** penalty) under a
    prefix-dependent toy model: log-probs from a seeded table indexed by the
    row, the position and the previous token. Ids equal, scores within
    1e-6."""
    Vt, Lt, Bt, K = 5, 4, 2, 3
    g = torch.Generator().manual_seed(0)
    table = torch.log_softmax(torch.randn(Bt, Lt, Vt + 1, Vt, generator=g), -1)

    def next_logp(prefix, t, expanded):
        rows = torch.arange(Bt).repeat_interleave(K) if expanded else torch.arange(Bt)
        prev = prefix[:, t - 1] + 1 if t > 0 else torch.zeros(len(rows), dtype=torch.long)
        return table[rows, t, prev]

    ids, scores = beam_search(next_logp, Bt, Lt, Vt, beam_size=K, length_penalty=0.6)
    for b in range(Bt):
        beams = [((), 0.0)]
        for t in range(Lt):
            cands = [(seq + (v,), s + float(table[b, t, seq[-1] + 1 if seq else 0, v]))
                     for seq, s in beams for v in range(Vt)]
            beams = sorted(cands, key=lambda c: -c[1])[:K]
        seq, s = max(beams, key=lambda c: c[1])
        assert tuple(ids[b].tolist()) == seq
        assert scores[b].item() == pytest.approx(s / Lt ** 0.6, abs=1e-6)


def test_lstm_beam_in_bf16_serving_weights(models):
    """The serving dtype: bf16 weights, float32 log-softmax and scores;
    finite scores, ids in range."""
    _, _, pm = models["lstm"]
    bf = DenoiseSeq2Seq(V, 2, L).to(torch.bfloat16).eval()
    bf.load_state_dict(pm.state_dict())
    x, li = (torch.tensor(a) for a in _inputs(6))
    ids, scores = beam_decode_any(bf, x, li, 1 - li, beam_size=4)
    assert scores.dtype == torch.float32 and torch.isfinite(scores).all()
    assert bool(((ids >= 0) & (ids < V)).all())


@pytest.mark.parametrize("backbone", ["lstm", "transformer"])
def test_beam_refuses_train_mode(models, backbone):
    _, _, pm = models[backbone]
    x, li = (torch.tensor(a) for a in _inputs())
    pm.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            beam_decode_any(pm, x, li, 1 - li, beam_size=2)
    finally:
        pm.eval()
