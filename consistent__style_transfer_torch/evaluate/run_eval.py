"""Eval runner (reference ``evaluate/eval.py``): loads test originals +
``.tsf`` transfers in the 0-file-then-1-file order, then prints

- STI (mean direction-corrected EMD; the target style for the 0-file's
  transfers is 1 and vice versa, ``eval.py:31``),
- CP (mean WMD between style-masked transfer and style-masked original;
  reference passes transfers as the 'references' side, ``eval.py:41-43``),
- NT (fraction of pairs whose transfer scored at least as natural as the
  original under the adversarial LR, ``eval.py:45-52``),

and the extras the reference never reported: ACC (the eval classifier's
agreement with the target style), self-BLEU, and ref-BLEU where
``reference.{0,1}`` hold one line a test sentence.

The port's copy of the JAX package's ``evaluate/run_eval.py``; it reads the
artifacts of ``evaluate/prepare.py`` on the host.
"""

from __future__ import annotations

import math
import os

from ..text.fasttext_cls import FastTextClassifier
from ..utils.io import read_lines
from .bleu import corpus_bleu, self_bleu
from .content import calculate_wmd_scores, load_masked_word2vec, mask_style_words
from .intensity import calculate_stis
from .lexicon import load_lexicon, load_model
from .naturalness import (
    UnigramNaturalnessClassifier,
    aggregate_judgments,
    generate_judgments,
)
from .prepare import eval_paths


def _mean(seq):
    seq = [s for s in seq if not math.isinf(s) and not math.isnan(s)]
    return sum(seq) / max(len(seq), 1)


def run_eval(data_dir: str, out_dir: str, eval_dir: str, dataset: str, ver: str,
             quiet: bool = False) -> dict:
    p = eval_paths(eval_dir, dataset, ver)
    say = (lambda *a: None) if quiet else print

    ori_0 = read_lines(f"{data_dir}/style.test.0")
    ori_1 = read_lines(f"{data_dir}/style.test.1")
    origin = ori_0 + ori_1
    tsf_0 = read_lines(f"{out_dir}/style.test.0.tsf")
    tsf_1 = read_lines(f"{out_dir}/style.test.1.tsf")
    transfer = tsf_0 + tsf_1

    # STI: target style per file = opposite of the source style
    labels = [1] * len(tsf_0) + [0] * len(tsf_1)
    sti_model = FastTextClassifier.load_model(p["classifier"])
    stis = calculate_stis(origin, transfer, labels, sti_model)
    sti = _mean(stis)
    say("STI (higher is better): %.4f" % sti)

    # CP: WMD over style-masked text
    lexicon = load_lexicon(p["lexicon"])
    w2v = load_masked_word2vec(p["mask_w2v"])
    masked_origin = mask_style_words(origin, lexicon)
    masked_transfer = mask_style_words(transfer, lexicon)
    wmd_scores = calculate_wmd_scores(masked_transfer, masked_origin, w2v)
    cp = _mean(wmd_scores)
    say("CP (lower is better): %.4f" % cp)

    # NT: relative judgments against the adversarial classifier
    vectorizer = load_model(p["vectorizer"])
    adv = UnigramNaturalnessClassifier(p["adv_model"], vectorizer)
    judgments = generate_judgments(adv.score(origin), adv.score(transfer))
    nt = aggregate_judgments(judgments)
    say("NT (higher is better): %.4f" % nt)

    results = {"STI": sti, "CP": cp, "NT": nt}

    hits = 0
    for text, tgt in zip(transfer, labels):
        pred, _ = sti_model.predict(text, k=1)
        hits += int(pred[0] == f"__label__{tgt}")
    results["ACC"] = hits / max(len(transfer), 1)
    say("ACC (transfer accuracy): %.4f" % results["ACC"])
    results["selfBLEU"] = self_bleu(transfer, origin)
    say("self-BLEU: %.2f" % results["selfBLEU"])
    ref0, ref1 = f"{data_dir}/reference.0", f"{data_dir}/reference.1"
    if os.path.exists(ref0) and os.path.exists(ref1):
        refs = read_lines(ref0) + read_lines(ref1)
        if len(refs) == len(transfer):
            results["refBLEU"] = corpus_bleu(transfer, refs)
            say("ref-BLEU: %.2f" % results["refBLEU"])

    return results
