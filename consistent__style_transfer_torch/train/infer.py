"""Inference: style transfer of whole splits into ``.tsf`` text files.

Output contract of the JAX package (``train/infer.py``) and the reference
(``src/main_optimize.py:157-174`` + ``:243-255``): for each split in (train,
test), decode every sentence to the *opposite* style with a greedy
``max_len`` rollout (a beam search with ``beam_size`` > 1), BPE-decode, and
route by the *source* label into
``output/<ds>-<ver>/style.<split>.{0,1}.tsf``.

The loop keeps the device busy: batch assembly and the host->device copy run
in the prefetcher's thread, each decode is queued on the stream without
waiting (on the card a greedy decode is one CUDA graph replay), and the copy
of the ids back to the host plus the BPE decode run in a small thread pool.

Under the launcher (``parallel/``) each data rank decodes its rows of every
batch; the ids are gathered over the data group in rank order, the padding
rows dropped by ``batch.valid``, and rank 0 writes the files, in corpus
order, so they equal a one-process run's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import torch

from ..config import Config
from ..data.pipeline import make_batches
from ..data.prefetch import DevicePrefetcher
from ..models.beam import beam_decode_any
from ..parallel.mesh import barrier, is_main
from ..parallel.sharding import all_gather_rows, data_group, shard_batch
from .common import generator_call, get_corpus
from .graphs import step_runner


def make_transfer_step(model, beam_size: int = 1):
    """step(x (B, L) int, labels (B,) int) -> ids (B, max_len) int32, on the
    model's device: decode to the opposite style (labels -> 1 - labels),
    greedy, or with ``beam_size`` > 1 the beam search of either backbone
    (``models/beam.py::beam_decode_any``, length penalty 0.6).

    On the card the greedy decode of either backbone (the LSTM's with the
    decode-head kernel in each of its steps) is a CUDA graph, one per input
    shape (:class:`~.graphs.GraphedStep`; batches are padded to one shape),
    and the ids it returns are the graph's output buffer, which the next
    call overwrites: copy them before the next call. The beam, and
    everything on the CPU, runs eagerly."""
    if beam_size > 1:
        def beam_step(x, labels):
            return beam_decode_any(model, x, labels, 1 - labels, beam_size=beam_size)[0]

        return beam_step

    def greedy(inputs, key=None):
        return generator_call(model, inputs["x"], inputs["labels"], None, 1 - inputs["labels"],
                              mode="greedy")

    runner = step_runner(greedy, next(model.parameters()).device)

    @torch.inference_mode()
    def step(x, labels):
        return runner({"x": x, "labels": labels}, tuple(x.shape))

    step.runner = runner  # its graphs, on the card
    return step


def transfer_split(cfg: Config, model, tokenizer, split: str,
                   step_fn=None, mesh=None) -> dict[int, list[str]]:
    """Transfer one split (greedy, or a beam of ``cfg.beam_size``); returns
    {source_label: [decoded lines]} in corpus order. With a ``mesh`` each
    data rank decodes its rows of a batch and rank 0 gets the gathered
    lines; the other ranks return empty lists."""
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

    group, main = data_group(mesh), is_main()
    with ThreadPoolExecutor(max_workers=3) as ex:
        chunks = []
        for batch, arrays in DevicePrefetcher(it, next(model.parameters()).device,
                                              shard_fn=partial(shard_batch, mesh=mesh)):
            # a copy on the stream: a graphed step's next call overwrites
            # its ids while this batch's are still in flight
            ids = all_gather_rows(step_fn(arrays["x"], arrays["labels"]).clone(), group)
            if main:
                chunks.append(ex.submit(drain, ids, batch))
        for c in chunks:  # corpus order preserved
            part = c.result()
            routed[0] += part[0]
            routed[1] += part[1]
    return routed


def tsf_paths(cfg: Config, split: str) -> list[str]:
    return [f"{cfg.run_out_dir}/style.{split}.{label}.tsf" for label in (0, 1)]


def write_tsf(cfg: Config, split: str, routed: dict[int, list[str]]) -> list[str]:
    os.makedirs(cfg.run_out_dir, exist_ok=True)
    paths = tsf_paths(cfg, split)
    for label, path in zip((0, 1), paths):
        with open(path, "w", encoding="utf-8") as f:
            for line in routed[label]:
                f.write(line + "\n")
    return paths


def run_inference(cfg: Config, model, tokenizer, splits=("train", "test"),
                  mesh=None, step_fn=None) -> list[str]:
    """Transfer ``splits`` to ``.tsf`` files (written by rank 0 under a
    ``mesh``) with ``step_fn`` (default :func:`make_transfer_step`'s);
    returns their paths on every rank."""
    step_fn = step_fn or make_transfer_step(model, cfg.beam_size)
    out_paths: list[str] = []
    for split in splits:
        routed = transfer_split(cfg, model, tokenizer, split, step_fn=step_fn, mesh=mesh)
        out_paths += write_tsf(cfg, split, routed) if is_main() else tsf_paths(cfg, split)
    barrier()  # the files are whole before any rank goes on to read them
    return out_paths
