"""A run of each cell with the look for a card skipped, on the CPU at the
tiny sizes, comes out correct; with the timed path broken underneath it
comes out not correct, once for each fault the cell can have: a step that
leaves its state unchanged, half of the batch left out (its rows dropped,
or every row decoded and the losses taken over half of them), a token or a
label altered where it is produced. The control (the reference in the
precision below the configuration's, in the program's place) reads far
above a sound run."""

from __future__ import annotations

import torch

from conftest import run_cpu


def control_reads_far_above(out, control="control"):
    """The control reads above ten times a sound run in one compared number
    at least. (The limits are set at the cells' own sizes; the `cuda` test
    holds the control to them there.)"""
    checks = out["checks"]
    return any(out["control"][control][k] > 10 * checks[k]["value"]
               for k in checks if k in out["control"][control])


def test_optimize_sound_run_is_correct(checkout):
    out = run_cpu(checkout, "yelp.optimize", control=1)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"optimize_sent_per_s", "setup_s"}
    assert control_reads_far_above(out)
    for fault in ("token", "half_batch", "half_loss", "unchanged"):
        assert control_reads_far_above(out, fault), fault


def test_optimize_state_left_unchanged(checkout, monkeypatch):
    from consistent__style_transfer_torch.train import state

    monkeypatch.setattr(state.AdamWithClip, "step", lambda self: None)
    out = run_cpu(checkout, "yelp.optimize")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > out["checks"]["change_gap"]["limit"]


def test_optimize_half_of_the_batch(checkout, monkeypatch):
    from consistent__style_transfer_torch.train import optimize

    real = optimize.make_optimize_steps

    def halved(*args, **kw):
        steps = real(*args, **kw)

        def fused_step(batch, *a, **k):
            return steps.fused_step({key: v[: v.shape[0] // 2] for key, v in batch.items()},
                                    *a, **k)
        return steps._replace(fused_step=fused_step)

    monkeypatch.setattr(optimize, "make_optimize_steps", halved)
    out = run_cpu(checkout, "yelp.optimize")
    assert not out["correct"]
    assert out["checks"]["rows_missing"]["value"] > 0


def test_optimize_losses_over_half_of_the_batch(checkout, monkeypatch):
    """Every row decoded, each training loss averaged over the first half of
    the rows (the validation's masked losses as they are)."""
    from consistent__style_transfer_torch.train import optimize

    def half(t, dim=0):
        return t.narrow(dim, 0, t.shape[dim] // 2)

    ce, sq, bce, tokens = (optimize.cross_entropy, optimize.mse, optimize.bce_with_logits,
                           optimize.softmax_cross_entropy_tokens)
    monkeypatch.setattr(optimize, "cross_entropy", lambda z, y, mask=None: (
        ce(half(z), half(y)) if mask is None else ce(z, y, mask)))
    monkeypatch.setattr(optimize, "mse", lambda p, t, mask=None: (
        sq(half(p), half(t)) if mask is None else sq(p, t, mask)))
    monkeypatch.setattr(optimize, "bce_with_logits", lambda z, t: bce(half(z), half(t)))
    # the training step's token grid is time-major: (L, B, V) against (L, B)
    monkeypatch.setattr(optimize, "softmax_cross_entropy_tokens", lambda z, y, row_mask=None: (
        tokens(half(z, 1), half(y, 1)) if row_mask is None else tokens(z, y, row_mask)))
    out = run_cpu(checkout, "yelp.optimize")
    assert not out["correct"]
    assert out["checks"]["rows_missing"]["value"] == 0
    assert out["checks"]["input_rows_unmoved"]["value"] > 0


def test_optimize_token_altered(checkout, monkeypatch):
    from consistent__style_transfer_torch.models import generator

    real = generator.hard_sample_st

    def altered(probs):
        out = real(probs)
        return torch.cat([out[..., :1, :].roll(1, dims=-1), out[..., 1:, :]], dim=-2)

    monkeypatch.setattr(generator, "hard_sample_st", altered)
    out = run_cpu(checkout, "yelp.optimize")
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > out["checks"]["token_gap"]["limit"]


def test_pretrain_sound_run_is_correct(checkout):
    out = run_cpu(checkout, "book.pretrain", control=1)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"pretrain_sent_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    for fault in ("half_batch", "unchanged"):
        assert control_reads_far_above(out, fault), fault
    assert out["control"]["control"]["fails"]


def test_pretrain_state_left_unchanged(checkout, monkeypatch):
    from consistent__style_transfer_torch.train import state

    monkeypatch.setattr(state.AdamWithClip, "step", lambda self: None)
    assert not run_cpu(checkout, "book.pretrain")["correct"]


def test_pretrain_half_of_the_batch(checkout, monkeypatch):
    from consistent__style_transfer_torch.train import pretrain

    real = pretrain.make_pretrain_steps

    def halved(*args, **kw):
        train_step, eval_step = real(*args, **kw)

        def step(batch, flags, generator=None):
            return train_step({k: v[: v.shape[0] // 2] for k, v in batch.items()}, flags,
                              generator)
        return step, eval_step

    monkeypatch.setattr(pretrain, "make_pretrain_steps", halved)
    assert not run_cpu(checkout, "book.pretrain")["correct"]


def test_pretrain_label_altered(checkout, monkeypatch):
    from consistent__style_transfer_torch.data import wmd_labels

    real = wmd_labels.SinkhornWmdLabeler.label_pairs

    def altered(self, *args):
        out = real(self, *args).clone()
        out[0] += 1.0
        return out

    monkeypatch.setattr(wmd_labels.SinkhornWmdLabeler, "label_pairs", altered)
    out = run_cpu(checkout, "book.pretrain")
    assert not out["correct"]
    assert out["checks"]["wmd_gap"]["value"] > out["checks"]["wmd_gap"]["limit"]
