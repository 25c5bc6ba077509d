"""Eval preparation (reference ``evaluate/prepare.py``): idempotently
(existence-checked) trains

1. the fasttext-style supervised style classifier from ``__label__<s>\\t<text>``
   train/dev files, printing N / P@1 / R@1 (``prepare.py:33-60``), on
   ``device``;
2. the style lexicon + binary unigram vectorizer + style-masked word2vec
   (``prepare.py:63-79``);
3. the per-model-version adversarial naturalness LR on transferred-train vs
   original-train sentences (``prepare.py:83-98``).

Artifact layout mirrors the reference under ``<eval_dir>/eval_dump`` and
``<eval_dir>/eval_tmp``. The port's copy of the JAX package's
``evaluate/prepare.py``: the classifier (``model_<ds>.npz``), the lexicon
(``lexicon_<ds>.json``) and the masked word2vec (``mask_w2v_<ds>.npz``) have
the JAX package's names and formats; the vectorizer
(``vectorizer_<ds>.json``) and the adversarial LR
(``adv_models/unigram_lr_<ver>_<ds>.npz``) are the port's own formats,
where the JAX package pickles scikit-learn objects. Both L1 LRs (the
lexicon's and the adversarial one) fit with the port's C++ newGLMNET unless
``prefer_native`` is false."""

from __future__ import annotations

import os
import time

from ..text.fasttext_cls import FastTextClassifier
from ..utils.io import read_lines, write_lines
from .content import mask_style_words, train_masked_word2vec
from .lexicon import generate_lexicon, load_model, save_model
from .naturalness import train_adversarial_lr


def eval_paths(eval_dir: str, dataset: str, ver: str | None = None) -> dict:
    d = {
        "dump": f"{eval_dir}/eval_dump",
        "tmp": f"{eval_dir}/eval_tmp",
        "classifier": f"{eval_dir}/eval_dump/model_{dataset}.npz",
        "lexicon": f"{eval_dir}/eval_dump/lexicon_{dataset}.json",
        "vectorizer": f"{eval_dir}/eval_dump/vectorizer_{dataset}.json",
        "mask_w2v": f"{eval_dir}/eval_dump/mask_w2v_{dataset}.npz",
    }
    if ver is not None:
        d["adv_model"] = f"{eval_dir}/eval_dump/adv_models/unigram_lr_{ver}_{dataset}.npz"
    return d


def masked_w2v_texts(data_dir: str, lexicon) -> list[str]:
    """The masked word2vec's corpus: every train and dev line of
    ``data_dir`` with the lexicon's words masked."""
    texts = []
    for name in sorted(os.listdir(data_dir)):
        if ("train" in name or "dev" in name) and not name.endswith(".tsf"):
            texts += read_lines(f"{data_dir}/{name}")
    return mask_style_words(texts, lexicon)


def run_prepare(data_dir: str, out_dir: str, eval_dir: str, dataset: str,
                ver: str | None = None, seed: int = 0, quiet: bool = False,
                device="cuda", prefer_native: bool = True) -> dict:
    """data_dir: <base>/data/<ds>; out_dir: <base>/output/<ds>-<ver>;
    ``device``: where the classifier is fitted; ``prefer_native``: the
    masked word2vec's trainer and the L1 LRs' solver (false: numpy and
    Python). Returns the paths and, under "timings", the seconds of each
    substage that ran; where the adversarial LR was fitted, under "adv_lr",
    its parts' seconds (reading and writing the files, the vectorizer's
    transform, the fit) and the fit's Newton iterations and inner passes
    (``train_adversarial_lr``), which it also prints."""
    p = eval_paths(eval_dir, dataset, ver)
    os.makedirs(p["dump"], exist_ok=True)
    os.makedirs(p["tmp"], exist_ok=True)
    os.makedirs(f"{p['dump']}/adv_models", exist_ok=True)
    say = (lambda *a: None) if quiet else print
    timings: dict[str, float] = {}
    t0 = time.perf_counter()

    # 1. style classifier
    if not os.path.exists(p["classifier"]):
        say("\n<-TRAINING STYLE CLASSIFIER->")
        for split, out in (("train", f"{p['tmp']}/{dataset}.train"),
                           ("dev", f"{p['tmp']}/{dataset}.dev")):
            lines = []
            for name in sorted(os.listdir(data_dir)):
                if split in name and not name.endswith(".tsf"):
                    label = name.split(".")[-1]
                    lines += [f"__label__{label}\t{s}" for s in read_lines(f"{data_dir}/{name}")]
            write_lines(lines, out)
        model = FastTextClassifier(seed=seed, device=device).fit_file(f"{p['tmp']}/{dataset}.train")
        n, prec, rec = model.test(f"{p['tmp']}/{dataset}.dev")
        say(f"N\t{n}")
        say("P@1\t{:.3f}".format(prec))
        say("R@1\t{:.3f}".format(rec))
        model.save_model(p["classifier"])
        timings["classifier_s"] = time.perf_counter() - t0

    # 2. lexicon + masked word2vec
    t0 = time.perf_counter()
    if not (os.path.exists(p["lexicon"]) and os.path.exists(p["vectorizer"])
            and os.path.exists(p["mask_w2v"])):
        say("\n<-GENERATING LEXICON & TRAINING WORD2VEC->")
        lexicon, _ = generate_lexicon(
            f"{data_dir}/style.train.0", f"{data_dir}/style.train.1",
            p["lexicon"], p["vectorizer"], seed=seed, prefer_native=prefer_native,
        )
        timings["lexicon_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        masked = masked_w2v_texts(data_dir, lexicon)
        timings["mask_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        say("Training masked word2vec model...")
        train_masked_word2vec(masked, p["mask_w2v"], seed=seed, prefer_native=prefer_native)
        timings["mask_w2v_s"] = time.perf_counter() - t0

    # 3. adversarial naturalness classifier (per model version)
    t0 = time.perf_counter()
    if ver is not None and not os.path.exists(p["adv_model"]):
        say("\n<-TRAINING ADVERSARIAL CLASSIFIER->")
        tsf, ori = [], []
        for name in sorted(os.listdir(out_dir)):
            if "train" in name:
                tsf += read_lines(f"{out_dir}/{name}")
        for name in sorted(os.listdir(data_dir)):
            if "train" in name and not name.endswith(".tsf"):
                ori += read_lines(f"{data_dir}/{name}")
        write_lines(tsf, f"{p['tmp']}/{dataset}-{ver}.train.tsf")
        write_lines(ori, f"{p['tmp']}/{dataset}-{ver}.train.ori")
        lr, parts = train_adversarial_lr(tsf, ori, load_model(p["vectorizer"]), seed=seed,
                                         prefer_native=prefer_native)
        save_model(lr, p["adv_model"])
        timings["adv_lr_s"] = time.perf_counter() - t0
        p["adv_lr"] = {"read_s": timings["adv_lr_s"] - parts["transform_s"] - parts["fit_s"],
                       **parts}
        say(f"[prepare] adversarial LR: {p['adv_lr']}")
    # keys appear only for substages that actually ran (idempotent skips
    # would otherwise record misleading ~0 s entries)
    say(f"[prepare] timings: {timings}")

    p["timings"] = timings
    return p
