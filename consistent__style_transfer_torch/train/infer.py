"""Inference: style transfer of whole splits into ``.tsf`` text files.

Output contract of the JAX package (``train/infer.py``) and the reference
(``src/main_optimize.py:157-174`` + ``:243-255``): for each split in (train,
test), decode every sentence to the *opposite* style with a greedy
``max_len`` rollout (a beam search with ``beam_size`` > 1), BPE-decode, and
route by the *source* label into
``output/<ds>-<ver>/style.<split>.{0,1}.tsf``.

The loop keeps the device busy: batch assembly and the host->device copy run
in the prefetcher's thread, each decode is queued on the stream without
waiting, and the copy of the ids back to the host plus the BPE decode run in
a small thread pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import Config
from ..data.pipeline import make_batches
from ..data.prefetch import DevicePrefetcher
from ..models.beam import beam_decode_any
from .common import generator_call, get_corpus


def make_transfer_step(model, beam_size: int = 1):
    """step(x (B, L) int, labels (B,) int) -> ids (B, max_len) int32, on the
    model's device: decode to the opposite style (labels -> 1 - labels),
    greedy, or with ``beam_size`` > 1 the beam search of either backbone
    (``models/beam.py::beam_decode_any``, length penalty 0.6)."""
    if beam_size > 1:
        def beam_step(x, labels):
            return beam_decode_any(model, x, labels, 1 - labels, beam_size=beam_size)[0]

        return beam_step

    @torch.inference_mode()
    def step(x, labels):
        return generator_call(model, x, labels, None, 1 - labels, mode="greedy")

    return step


def transfer_split(cfg: Config, model, tokenizer, split: str,
                   step_fn=None) -> dict[int, list[str]]:
    """Transfer one split (greedy, or a beam of ``cfg.beam_size``); returns
    {source_label: [decoded lines]} in corpus order."""
    step_fn = step_fn or make_transfer_step(model, cfg.beam_size)
    corpus = get_corpus(cfg, split, tokenizer)
    it = make_batches(corpus, cfg.batch_size, cfg.max_len, "optimize",
                      shuffle=False, seed=cfg.seed)
    routed: dict[int, list[str]] = {0: [], 1: []}

    def drain(ids, batch):
        tokens = ids.cpu().numpy()  # waits for this batch's decode only
        labels = batch["labels"]
        out: tuple[list[str], list[str]] = ([], [])
        for i in range(batch.valid):
            out[int(labels[i])].append(tokenizer.decode(tokens[i].tolist()))
        return out

    with ThreadPoolExecutor(max_workers=3) as ex:
        chunks = [
            ex.submit(drain, step_fn(arrays["x"], arrays["labels"]), batch)
            for batch, arrays in DevicePrefetcher(it, next(model.parameters()).device)
        ]
        for c in chunks:  # corpus order preserved
            part = c.result()
            routed[0] += part[0]
            routed[1] += part[1]
    return routed


def write_tsf(cfg: Config, split: str, routed: dict[int, list[str]]) -> list[str]:
    os.makedirs(cfg.run_out_dir, exist_ok=True)
    paths = []
    for label in (0, 1):
        path = f"{cfg.run_out_dir}/style.{split}.{label}.tsf"
        with open(path, "w", encoding="utf-8") as f:
            for line in routed[label]:
                f.write(line + "\n")
        paths.append(path)
    return paths


def run_inference(cfg: Config, model, tokenizer, splits=("train", "test")) -> list[str]:
    step_fn = make_transfer_step(model, cfg.beam_size)
    out_paths: list[str] = []
    for split in splits:
        routed = transfer_split(cfg, model, tokenizer, split, step_fn=step_fn)
        out_paths += write_tsf(cfg, split, routed)
    return out_paths
