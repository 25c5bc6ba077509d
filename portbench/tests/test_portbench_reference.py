"""The plain reference agrees with the port at tiny widths on the CPU, given
the same seeded weights, inputs and generator seeds: the generator's decode
modes, the reference fed along a decode's own tokens, the scorers and D in
train mode (the same dropout masks), and the WMD labels."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.lib.harness import seeded_weights
from portbench.reference import models as ref
from portbench.reference.wmd import WmdLabels

V, L, B = 50, 6, 4


def config():
    with open(os.path.join(ROOT, "portbench", "configs", "book.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg.update(vocab_size=V, max_len=L, batch_size=B)
    cfg["scorers"] = {**cfg["scorers"], "d_model": 32, "n_heads": 2, "n_layers": 1}
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(port modules, reference modules) with the same seeded weights."""
    from consistent__style_transfer_torch.models import (DenoiseSeq2Seq, PairMatcher,
                                                         RelGANDiscriminator, TextCNN,
                                                         TransformerLM)

    cfg = config()
    s = cfg["scorers"]
    port = {"generator": DenoiseSeq2Seq(V, 2, L), "classifier": TextCNN(V),
            "matcher": PairMatcher(V, s["d_model"], s["n_heads"], s["n_layers"]),
            "lm": TransformerLM(V, s["d_model"], s["n_heads"], s["n_layers"]),
            "disc": RelGANDiscriminator(V)}
    mine = ref.build(cfg)
    for name, state in seeded_weights(cfg, 7, "cpu").items():
        port[name].load_state_dict(state, strict=True)
        mine[name].load_state_dict(state, strict=True)
    return port, mine


def inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(1, V, (B, L), generator=g)
    return x, torch.randint(0, 2, (B,), generator=g)


def gens(seed=3):
    return torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("mode", ["st", "sched"])
def test_generator_training_modes(pair, mode):
    port, mine = pair
    x, labels = inputs()
    ga, gb = gens()
    teacher = None if mode == "st" else x
    port["generator"].train()
    mine["generator"].train()
    a = port["generator"](x, labels, teacher, 1 - labels, mode=mode, tau=0.1,
                          time_major_out=True, generator=ga)
    b = mine["generator"](x, labels, teacher, 1 - labels, mode=mode, tau=0.1,
                          time_major_out=True, generator=gb)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_forced_decode_along_the_ports_tokens(pair):
    """Fed the tokens the port's straight-through decode produced, with the
    same dropout draws, the reference puts each of them first: a gap of 0."""
    from portbench.reference.compare import logit_gap

    port, mine = pair
    x, labels = inputs(1)
    ga, gb = gens(6)
    port["generator"].train()
    mine["generator"].train()
    with torch.no_grad():
        probs = port["generator"](x, labels, None, 1 - labels, mode="st", tau=0.1,
                                  time_major_out=True, generator=ga)
        tokens = probs.argmax(-1).t()
        logits = ref.forced_st_logits(mine["generator"], x, labels, 1 - labels, tokens, gb)
    assert logit_gap(logits, tokens) == 0.0


def test_scorers_and_discriminator_in_train_mode(pair):
    port, mine = pair
    x, labels = inputs(2)
    soft = torch.softmax(torch.randn(L, B, V, generator=torch.Generator().manual_seed(5)), -1)
    for name in ("classifier", "matcher", "lm", "disc"):
        port[name].train()
        mine[name].train()
    ga, gb = gens(4)
    torch.testing.assert_close(port["classifier"](soft, ga, time_major=True),
                               mine["classifier"](soft, gb, time_major=True))
    torch.testing.assert_close(port["matcher"](soft, x, ga, time_major=True),
                               mine["matcher"](soft, x, gb, time_major=True))
    torch.testing.assert_close(port["lm"](x, ga), mine["lm"](x, gb))
    torch.testing.assert_close(port["disc"](soft, ga, time_major=True),
                               mine["disc"](soft, gb, time_major=True))
    torch.testing.assert_close(port["disc"](x, ga), mine["disc"](x, gb))


def test_wmd_labels(tmp_path):
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.text.bpe import BPETokenizer
    from consistent__style_transfer_torch.text.word2vec import Word2Vec

    rng = np.random.default_rng(0)
    vocab = {t: i for i, t in enumerate(["<pad>", "<s>", "</s>", "<unk>"]
                                        + [f"t{i}</w>" for i in range(30)])}
    tok = BPETokenizer(vocab, [])
    w2v = Word2Vec(None, dim=8)
    w2v.vocab = {f"t{i}</w>": i for i in range(25)}  # five tokens have no vector
    w2v.vectors = rng.standard_normal((25, 8)).astype(np.float32)
    w2v.save(str(tmp_path / "w2v.npz"))
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    w2v.init_sims()
    ids1 = rng.integers(4, 34, (16, 12)).astype(np.int32)
    ids2 = rng.integers(4, 34, (16, 12)).astype(np.int32)
    lens1, lens2 = rng.integers(0, 13, 16), rng.integers(1, 13, 16)
    lens2[3] = 0
    ids1[5, :] = 30  # a side with no known token
    for ids, lens in ((ids1, lens1), (ids2, lens2)):
        ids[np.arange(12)[None, :] >= lens[:, None]] = 0
    port = SinkhornWmdLabeler(w2v, tok, max_atoms=12).label_pairs(ids1, lens1, ids2, lens2)
    mine = WmdLabels(str(tmp_path / "vocab.json"), str(tmp_path / "w2v.npz"), "cpu")
    torch.testing.assert_close(mine.labels(ids1, ids2), port, rtol=1e-4, atol=1e-5)
