"""The optimize stage's ``megastep_k`` on the CPU, in float32:

- the port's ``MegaBatches`` groups batches as the JAX package's does: the
  same stacked arrays in the same order, a last short group at its true
  size, the same ``valid`` counts and length;
- ``run_optimize`` with ``megastep_k=3`` equals the per-batch loop
  (``megastep_k=1``, one batch a group; the counterpart of
  tests/test_megastep.py:63): after two epochs of 4 batches (a group of 3,
  then a tail of 1), the G and D parameters, both Adam states and the
  generators' states bit for bit, and the logged losses, D's cadence
  (epoch-local index % ``d_update_every``) and the validation losses equal.
  On the CPU every group runs ``fused_step`` eagerly, in the same order and
  with the same generators, so dropout and the sched coins can stay on and
  still be compared exactly. The card replays CUDA graphs instead:
  tests/test_torch_megastep_cuda.py holds a replay against the eager step
  there, with dropout and coins drawn as well as without.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.data.pipeline import Batch as JaxBatch  # noqa: E402
from consistent__style_transfer_tpu.data.pipeline import MegaBatches as JaxMegaBatches  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.data.pipeline import Batch, MegaBatches  # noqa: E402
from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM  # noqa: E402
from consistent__style_transfer_torch.train import optimize  # noqa: E402
from consistent__style_transfer_torch.train.checkpoint import StateCheckpointer  # noqa: E402
from consistent__style_transfer_torch.train.common import get_tokenizer  # noqa: E402

SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_batches,k", [(6, 4), (8, 4), (3, 1), (2, 5)])
def test_megabatches_equal_jax_grouping(n_batches, k):
    rng = np.random.default_rng(n_batches * 10 + k)
    arrays = [{"x": rng.integers(0, 50, (4, 6)).astype(np.int32),
               "labels": rng.integers(0, 2, (4,)).astype(np.int32)} for _ in range(n_batches)]
    valid = [4] * (n_batches - 1) + [3]
    ours = list(MegaBatches([Batch(a, v) for a, v in zip(arrays, valid)], k))
    theirs = list(JaxMegaBatches([JaxBatch(a, v) for a, v in zip(arrays, valid)], k))
    assert len(ours) == len(theirs) == -(-n_batches // k)
    assert len(MegaBatches([Batch(a, 4) for a in arrays], k)) == len(ours)
    for got, want in zip(ours, theirs):
        assert got.valid == want.valid
        assert sorted(got.arrays) == sorted(want.arrays)
        for key in want.arrays:
            np.testing.assert_array_equal(got.arrays[key], want.arrays[key])
    assert ours[-1].arrays["x"].shape[0] == n_batches - k * (len(ours) - 1)
    with pytest.raises(ValueError):
        MegaBatches([], 0)


def _run(tiny_corpus, root, k):
    cfg = make_config("tiny", data_dir=os.path.dirname(tiny_corpus), dump_dir=str(root / "dump"),
                      log_dir=str(root / "log"), out_dir=str(root / "out"), device="cpu",
                      dtype="float32", max_len=6, vocab_size=120, batch_size=3, epochs=2,
                      d_update_every=2, megastep_k=k, resume=True, w_copy=0.5,
                      w_copy_decay=0.5, **SCORER)
    Vt = len(get_tokenizer(cfg))
    pre = os.path.join(cfg.ds_dump_dir, "pretrain")
    os.makedirs(pre)
    for name, m in (("cls", TextCNN(Vt)), ("mat", PairMatcher(Vt, **PORT_SIZE)),
                    ("dn", TransformerLM(Vt, **PORT_SIZE))):
        torch.save(m.state_dict(), os.path.join(pre, f"{name}.pth"))
    optimize.run_optimize(cfg, progress=False)
    state = StateCheckpointer(os.path.join(cfg.ds_dump_dir, "optimize-v0", "full_state")).restore()
    with open(os.path.join(cfg.log_dir, "tiny", "optimize-v0", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return state, events


@pytest.fixture(scope="module")
def per_batch_run(tiny_corpus, tmp_path_factory):
    return _run(tiny_corpus, tmp_path_factory.mktemp("k1"), 1)


def _assert_same_run(got, want):
    (state, events), (ref_state, ref_events) = got, want
    for key in ("g", "d"):
        for name, t in ref_state[key].items():
            assert torch.equal(state[key][name], t), f"{key}.{name}"
    for key in ("g_opt", "d_opt"):
        for i, st in ref_state[key]["state"].items():
            for name, t in st.items():
                assert torch.equal(state[key]["state"][i][name], t), f"{key}[{i}].{name}"
    for key in ("generator", "d_generator", "step", "epoch", "best"):
        assert torch.equal(state[key], ref_state[key]) if key.endswith("generator") \
            else state[key] == ref_state[key], key
    assert ref_state["step"] == 8  # 12 train sentences, B=3: 4 batches an epoch

    def strip(evs):  # the host-clock rates differ
        drop = ("t", "sentences_per_sec", "steps_per_sec", "wall_s", "train_s", "epoch_sent_per_s")
        return [{k: v for k, v in e.items() if k not in drop} for e in evs]

    assert strip(events) == strip(ref_events)
    epochs = [e for e in events if "val_loss" in e]
    assert [e["train_steps"] for e in epochs] == [4, 4]
    assert [e["d_applies"] for e in epochs] == [2, 2]  # epoch-local batches 0 and 2
    assert [e["step"] for e in events if "loss" in e] == [0]  # logged every 20 steps


def test_megastep_3_equals_the_per_batch_loop(tiny_corpus, tmp_path, per_batch_run):
    _assert_same_run(_run(tiny_corpus, tmp_path / "k3", 3), per_batch_run)


@pytest.mark.parametrize("k", [2, 4, 5, 8])
def test_other_megastep_groupings_equal_the_per_batch_loop(tiny_corpus, tmp_path, per_batch_run,
                                                           k):
    """Two full groups an epoch (k=2), one group that is the whole epoch
    (k=4), and one short group larger than the epoch (k=5, 8)."""
    _assert_same_run(_run(tiny_corpus, tmp_path / f"k{k}", k), per_batch_run)


def test_megastep_k_must_be_positive(tiny_corpus, tmp_path):
    with pytest.raises(ValueError, match="megastep_k"):
        _run(tiny_corpus, tmp_path, 0)
