"""Full-state resume of the optimize stage (``Config.resume``), on the CPU in
float32:

- ``StateCheckpointer`` writes a payload and reads it back, keeps one
  checkpoint (``max_to_keep=1``), and reads nothing from an empty directory;
- ``AdamWithClip`` is the plain Adam on the CPU (``capturable`` only on the
  card) and equals optax's ``clip_by_global_norm`` + ``adam`` (the JAX
  package's ``adam_with_clip``) step for step; its state survives a
  ``state_dict`` round trip;
- ``run_optimize`` for 2 epochs equals 1 epoch, then a resumed run of the
  second: the G and D parameters, both Adam states with their step counts,
  the best validation loss and its file, the step counter and the random
  generators, bit for bit (the same CPU operations in the same order;
  dropout on, since the generators are saved and restored). The D-gradient
  accumulator is not saved (it restarts at zero on resume, as in the JAX
  package), so the tiny corpus is cut into 3 batches an epoch with
  ``d_update_every=2``: 3 is 1 mod 2, so the last batch of each epoch
  applies D and the accumulator carried over is zero either way.
"""

import json
import os
from copy import deepcopy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consistent__style_transfer_tpu.train.state import adam_with_clip  # noqa: E402
from consistent__style_transfer_torch.config import make_config  # noqa: E402
from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM  # noqa: E402
from consistent__style_transfer_torch.train import optimize  # noqa: E402
from consistent__style_transfer_torch.train.checkpoint import StateCheckpointer  # noqa: E402
from consistent__style_transfer_torch.train.common import get_tokenizer  # noqa: E402
from consistent__style_transfer_torch.train.state import AdamWithClip  # noqa: E402

SCORER = dict(scorer_layers=1, scorer_d_model=16, scorer_heads=2)
PORT_SIZE = dict(n_layers=1, d_model=16, n_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nested_equal(a, b, path="") -> None:
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _nested_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _nested_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_state_checkpointer_round_trip_keeps_one(tmp_path):
    ckpt = StateCheckpointer(str(tmp_path / "full_state"))
    assert ckpt.latest_step() is None and ckpt.restore() is None
    g = torch.Generator().manual_seed(3)
    payloads = []
    for step in (0, 1):
        payload = {"g": {"w": torch.randn(3, 4, generator=g)}, "epoch": step, "best": 2.5 - step,
                   "best_path": f"G_epoch_{step}.pth", "generator": g.get_state(),
                   "opt": torch.optim.Adam([torch.nn.Parameter(torch.ones(2))]).state_dict()}
        ckpt.save(step, payload)
        payloads.append(payload)
    assert os.listdir(tmp_path / "full_state") == ["state_1.pt"]
    assert ckpt.latest_step() == 1
    _nested_equal(ckpt.restore(), payloads[1])
    assert StateCheckpointer(str(tmp_path / "full_state")).restore()["best"] == 1.5


def test_adam_with_clip_equals_optax_and_round_trips():
    """Clip active (norm above 1) and inactive: the parameters after each
    of 4 steps within 1e-6 of optax's; then a copy restored from
    ``state_dict`` takes the same next step bit for bit."""
    rng = np.random.default_rng(0)
    init = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) * s for s in (3.0, 0.05, 2.0, 0.1)]
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    opt = AdamWithClip([p], lr=1e-2, clip=1.0)
    assert opt.adam.defaults["capturable"] is False
    tx = adam_with_clip(1e-2, 1.0)
    jp = jnp.asarray(init)
    state = tx.init(jp)
    for gr in grads:
        p.grad.copy_(torch.from_numpy(gr))
        opt.step()
        updates, state = tx.update(jnp.asarray(gr), state, jp)
        jp = jp + updates
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax.device_get(jp)), atol=1e-6)
    q = torch.nn.Parameter(p.detach().clone())
    copy = AdamWithClip([q], lr=1e-2, clip=1.0)
    copy.load_state_dict(deepcopy(opt.state_dict()))  # as if read back from a file
    for o, t in ((opt, p), (copy, q)):
        t.grad.copy_(torch.from_numpy(grads[0]))
        o.step()
    assert torch.equal(p, q)


def _cfg(tiny_corpus, dump, **kw):
    return make_config("tiny", data_dir=os.path.dirname(tiny_corpus), dump_dir=str(dump / "dump"),
                       log_dir=str(dump / "log"), out_dir=str(dump / "out"), device="cpu",
                       dtype="float32", max_len=6, vocab_size=120, batch_size=4,
                       d_update_every=2, resume=True, **SCORER, **kw)


def _pretrain_dumps(cfg) -> None:
    Vt = len(get_tokenizer(cfg))
    pre = os.path.join(cfg.ds_dump_dir, "pretrain")
    os.makedirs(pre, exist_ok=True)
    for name, m in (("cls", TextCNN(Vt)), ("mat", PairMatcher(Vt, **PORT_SIZE)),
                    ("dn", TransformerLM(Vt, **PORT_SIZE))):
        torch.save(m.state_dict(), os.path.join(pre, f"{name}.pth"))


def _epochs(cfg) -> list[dict]:
    with open(os.path.join(cfg.log_dir, cfg.dataset, f"optimize-{cfg.ver}", "events.jsonl")) as f:
        return [e for e in map(json.loads, f) if "val_loss" in e]


def test_two_epochs_equal_one_then_resume_one(tiny_corpus, tmp_path):
    straight = _cfg(tiny_corpus, tmp_path / "straight", epochs=2)
    _pretrain_dumps(straight)
    optimize.run_optimize(straight, progress=False)

    split = _cfg(tiny_corpus, tmp_path / "split", epochs=1)
    _pretrain_dumps(split)
    optimize.run_optimize(split, progress=False)
    state_dir = os.path.join(split.ds_dump_dir, "optimize-v0", "full_state")
    after_one = StateCheckpointer(state_dir).restore()
    assert after_one["epoch"] == 0 and after_one["step"] == 3
    split.epochs = 2
    optimize.run_optimize(split, progress=False)  # resumes at epoch 1

    assert os.listdir(state_dir) == ["state_1.pt"]
    want = StateCheckpointer(os.path.join(straight.ds_dump_dir, "optimize-v0",
                                          "full_state")).restore()
    got = StateCheckpointer(state_dir).restore()
    want_best = want.pop("best_path")
    got_best = got.pop("best_path")
    assert os.path.basename(got_best) == os.path.basename(want_best)
    _nested_equal(got, want)
    assert got["epoch"] == 1 and got["step"] == 6
    assert got["g_opt"]["state"][0]["step"].item() == 6  # G steps every batch
    assert got["d_opt"]["state"][0]["step"].item() == 4  # D at batches 0 and 2 of each epoch
    runs = _epochs(split)
    assert [e["epoch"] for e in runs] == [0, 1]  # the resumed run starts at the next epoch
    assert [e["val_loss"] for e in runs] == [e["val_loss"] for e in _epochs(straight)]
    assert [e["d_applies"] for e in runs] == [2, 2]
    assert got["best"] == min(e["val_loss"] for e in runs)
