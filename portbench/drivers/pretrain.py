"""The pretrain stage's traffic: a closed loop over the train split, one
graphed step of the three scorers a batch, as
``train/pretrain.py::run_pretrain`` makes it, with all three towers on
throughout (no freeze, no early stop: a freeze decided on seeded weights
would take the matcher's work, and the Sinkhorn's, out of some seeds' runs
and not others').

Set-up makes ``run_pretrain``'s calls: the cached tokenizer and word2vec
(trained once into the benchmark's cache by the port's ``get_tokenizer``
and ``get_w2v``), ``SinkhornWmdLabeler``, ``make_batches(..., "pretrain")``
(each batch's collate draws the noise and labels its pairs with the
Sinkhorn kernel, on the prefetcher's thread), the three towers with the
benchmark's seeded weights, one ``AdamWithClip``, ``make_pretrain_steps``
and the flag-tuple ``step_runner``. It drives that object through its
first ``check_steps`` steps and a validation pass (which captures the
graphs); the window goes on from the next batch, each epoch ending with a
validation pass over the dev split and the asynchronous saves of the
towers that improved. As in ``run_pretrain``, the host does not wait for a
step before it queues the next; the window closes when every queued step
has finished.

After the window the plain reference labels the first batches' pairs
itself, follows the first steps and validates, from the same ids, weights,
word vectors and generator seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time

import numpy as np
import torch

from portbench.counts import flops
from portbench.lib import harness
from portbench.reference import compare
from portbench.reference import pretrain as ref_pre
from portbench.reference.wmd import WmdLabels

BETA1 = 0.9
FLAGS = (True, True, True)
TOWERS = (("classifier", "cls"), ("matcher", "mat"), ("lm", "dn"))
KEYS = ("x", "nx1", "nx2", "nx3", "labels")


def run(ctx: harness.Context) -> harness.Outcome:
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.train.common import (build_classifier, build_lm,
                                                               build_matcher, get_corpus,
                                                               get_w2v, rank_generators)
    from consistent__style_transfer_torch.train.graphs import step_runner
    from consistent__style_transfer_torch.train.loop import validate
    from consistent__style_transfer_torch.train.pretrain import make_pretrain_steps, step_inputs
    from consistent__style_transfer_torch.train.state import AdamWithClip, AsyncSaver

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    cfg = harness.port_config(ctx, pretrain_lr=c["pretrain"]["lr"],
                              pretrain_clip=c["pretrain"]["clip"])
    tok = harness.tokenizer(cfg)
    # the cached word vectors are trained once, from a fixed seed
    w2v = get_w2v(dataclasses.replace(cfg, seed=0), tok)
    labeler = SinkhornWmdLabeler(w2v, tok, max_atoms=c["pretrain"]["label_atoms"], device=dev)
    V = c["vocab_size"]
    models = {"cls": build_classifier(cfg, V, dev), "mat": build_matcher(cfg, V, dev),
              "dn": build_lm(cfg, V, dev)}
    weights = harness.seeded_weights(c, ctx.seed, dev, names=[r for r, _ in TOWERS])
    for ref_name, name in TOWERS:
        models[name].load_state_dict(weights[ref_name], strict=True)
    del weights
    optimizer = AdamWithClip([p for _, n in TOWERS for p in models[n].parameters()],
                             cfg.pretrain_lr, cfg.pretrain_clip)
    train_step, eval_step = make_pretrain_steps(models, optimizer,
                                                autocast_dtype=torch.bfloat16
                                                if c["dtype"] == "bfloat16" else None)
    generator, _ = rank_generators(cfg.seed, dev, None)
    saver = AsyncSaver()
    run_step = step_runner(lambda inputs, flags: train_step(inputs, flags, generator), dev,
                           (generator,), before_capture=saver.wait)
    run_eval = step_runner(lambda inputs, flags: list(eval_step(inputs, flags).values()), dev,
                           before_capture=saver.wait)
    keys = step_inputs(FLAGS)
    B = cfg.batch_size
    train_it = make_batches(get_corpus(cfg, "train", tok), B, cfg.max_len, "pretrain",
                            shuffle=True, seed=cfg.seed, wmd_labeler=labeler)
    dev_it = make_batches(get_corpus(cfg, "dev", tok), B, cfg.max_len, "pretrain",
                          shuffle=False, seed=cfg.seed, wmd_labeler=labeler)
    dump = os.path.join(ctx.tmp_dir, "pretrain")
    os.makedirs(dump, exist_ok=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def epochs():
        while True:
            for batch, arrays in DevicePrefetcher(train_it, dev):
                yield batch.arrays, arrays
            yield None

    feed = epochs()
    cap = int(t.get("max_steps", 20000))
    loss_buf = torch.zeros(cap, 3, device=dev)
    state = {"n": 0, "val": 0}
    best = [float("inf")] * 3
    consumed = []  # host ids of the batches a traced part of the window consumes

    def group(record=None):
        a = time.perf_counter()
        item = next(feed)
        b = time.perf_counter()
        ctx.span("data_wait", a, b)
        if item is None:
            end_of_epoch()
            return
        host, arrays = item
        a = time.perf_counter()
        parts = run_step({k: arrays[k] for k in keys}, FLAGS)
        ctx.span("dispatch", a, time.perf_counter())
        loss_buf[state["n"]].copy_(torch.stack([parts[k] for k in ("cls", "mat", "dn")]))
        if record is not None:
            record(host, arrays)
        state["n"] += 1

    def end_of_epoch():
        a = time.perf_counter()
        val = validate(dev_it, run_eval, dev, shard=False, key=FLAGS,
                       inputs=(*keys, "row_mask"))
        for i, name in enumerate(("cls", "mat", "dn")):
            if val[i] <= best[i]:
                best[i] = val[i]
                saver.submit(models[name], os.path.join(dump, f"{name}.pth"))
        state["val"] += 1
        ctx.span("validation_and_save", a, time.perf_counter())

    # ---- set-up: the first steps, which the reference follows
    check_steps = int(t["check_steps"])
    first, first_grads, after = [], {}, {}

    def record(host, arrays):
        first.append(({k: host[k].copy() for k in KEYS}, arrays["wmd"].to("cpu", copy=True)))
        if state["n"] == 0:
            sync()
            for ref_name, name in TOWERS:
                for key, p in models[name].named_parameters():
                    m1 = optimizer.adam.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    first_grads[f"{ref_name}.{key}"] = (m1 / (1 - BETA1)).cpu()

    while state["n"] < check_steps:
        group(record)
    sync()
    for ref_name, name in TOWERS:
        for key, p in models[name].named_parameters():
            after[f"{ref_name}.{key}"] = p.detach().to("cpu", copy=True)
    first_losses = loss_buf[:check_steps].tolist()
    dev_first = list(dev_it)  # the set-up's validation, on batches the reference reads too
    val_prog = validate(dev_first, run_eval, dev, shard=False, key=FLAGS,
                        inputs=(*keys, "row_mask"))
    dev_first = [(b.arrays, b.valid) for b in dev_first]
    sync()

    # ---- the window
    readings = {}
    trace_from, trace_steps = int(t["trace_from"]), int(t["trace_steps"])
    tracer, trace, mark = None, None, {}

    def stop_trace():
        readings.update(trace_steps=state["n"] - mark["n"],
                        trace_val_passes=state["val"] - mark["val"])
        return tracer.stop()

    start_n = state["n"]
    t_open = ctx.open_window()
    while time.perf_counter() - t_open < ctx.seconds:
        if ctx.trace and tracer is None and state["n"] - start_n >= trace_from:
            from portbench.lib.trace import Tracer

            tracer = Tracer()
            tracer.start()
            mark = {"n": state["n"], "val": state["val"]}
        group((lambda host, arrays: consumed.append((host["nx1"].copy(), host["nx2"].copy())))
              if tracer is not None and trace is None else None)
        if tracer is not None and trace is None and state["n"] - mark["n"] >= trace_steps:
            trace = stop_trace()
    if tracer is not None and trace is None:
        trace = stop_trace()
    sync()  # the steps queued on the device finish inside the window
    window_s = time.perf_counter() - t_open
    n_window = state["n"] - start_n
    failed = int((~torch.isfinite(loss_buf[start_n:state["n"]])).any(dim=1).sum())
    saver.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_dev_batches = len(dev_first)
    readings.update(window=(t_open, t_open + window_s), window_s=window_s, steps=n_window,
                    val_passes=state["val"], step_flops=flops.pretrain_step(c),
                    val_flops=flops.pretrain_eval_batch(c) * n_dev_batches)
    vocab_path = cfg.vocab_paths[0]
    w2v_path = dataclasses.replace(cfg, seed=0).w2v_path

    del run_step, run_eval, models, optimizer, feed, loss_buf, labeler, train_step, eval_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    wmd = WmdLabels(vocab_path, w2v_path, dev, c["pretrain"]["sinkhorn_eps"],
                    c["pretrain"]["sinkhorn_iters"])
    if consumed:
        readings["sinkhorn_atoms"] = [wmd.atoms(a, b) for a, b in consumed]
        readings["sinkhorn_padded"] = (c["pretrain"]["label_atoms"],) * 2
    checks = check(ctx, wmd, first[:check_steps], first_losses, first_grads, after, val_prog,
                   dev_first, cfg.seed)
    return harness.Outcome({"pretrain_sent_per_s": n_window * B / window_s}, n_window, failed,
                           checks, readings, memory_peak, trace)


def check(ctx, wmd, first, losses, grads, after, val_prog, dev_first, seed: int):
    """The reference's labels, first steps and validation from the same
    ids, weights, word vectors and generator seed, against the program's:
    (name, value, limit) for each number compared; with ``ctx.control`` the
    control's and the planted faults' readings to ``ctx.control_readings``."""
    c, dev = ctx.config, ctx.device

    def on_dev(host):
        return {k: torch.as_tensor(host[k], device=dev) for k in KEYS}

    batches, wmd_gap = [], 0.0
    for host, prog_wmd in first:
        labels = wmd.labels(host["nx1"], host["nx2"])
        wmd_gap = max(wmd_gap, float((prog_wmd.float() - labels).abs().max()
                                     / labels.abs().max().clamp_min(1e-12)))
        batches.append({**on_dev(host), "wmd": labels.to(dev)})
    dev_b = []
    for arrays, valid in dev_first:
        rows = torch.as_tensor((np.arange(len(arrays["labels"])) < valid).astype(np.float32),
                               device=dev)
        dev_b.append(({**on_dev(arrays), "wmd": wmd.labels(arrays["nx1"], arrays["nx2"]).to(dev)},
                      rows))

    def follow(fault=None, products=None, labelled=batches):
        m = harness.reference_modules(c, ctx.seed, dev)
        gen = torch.Generator(dev).manual_seed(seed)
        with products or contextlib.nullcontext():
            out = ref_pre.first_steps(m, c, labelled, gen, fault)
            out["val"] = ref_pre.validation_losses(m, dev_b)
        return out

    ref = follow()
    init = {f"{name}.{k}": v.cpu() for name, state in
            harness.seeded_weights(c, ctx.seed, dev, names=ref_pre.TOWERS).items()
            for k, v in state.items()}

    def readings(p_losses, p_grads, p_after, p_val, p_wmd):
        out = compare.training_gaps(p_losses, p_grads, p_after, ref, init)
        val_gaps = [compare.relative_gap(p, r) for p, r in zip(p_val, ref["val"])]
        out["val_gap"], out["val_gaps"] = max(val_gaps), val_gaps
        out["wmd_gap"] = p_wmd
        return out

    def fails(out):
        return [k for k, lim in ctx.limits.items() if not out[k] <= lim]

    if ctx.control:
        from portbench.reference.lowp import Fp8Products

        # the control, one run: the Sinkhorn in bf16 labels the pairs, and the
        # scorers' products take and give fp8
        low = WmdLabels(wmd.vocab_path, wmd.w2v_path, dev, wmd.eps, wmd.iters, torch.bfloat16)
        low_batches, low_gap = [], 0.0
        for (host, _), b in zip(first, batches):
            labels = low.labels(host["nx1"], host["nx2"])
            low_gap = max(low_gap, float((labels - b["wmd"].cpu()).abs().max()
                                         / b["wmd"].abs().max().clamp_min(1e-12)))
            low_batches.append({**b, "wmd": labels.to(dev)})
        for name, kw, gap in (("control", {"products": Fp8Products(), "labelled": low_batches},
                               low_gap),
                              ("fp8_products", {"products": Fp8Products()}, 0.0),
                              ("half_batch", {"fault": "half_batch"}, 0.0)):
            out = follow(**kw)
            got = readings(out["losses"], out["grads"], out["params"], out["val"], gap)
            ctx.control_readings[name] = {**got, "fails": fails(got)}
        got = readings(ref["losses"], ref["grads"], init, ref["val"], 0.0)
        ctx.control_readings["unchanged"] = {**got, "fails": fails(got)}
    got = readings(losses, grads, after, val_prog, wmd_gap)
    if ctx.control:
        ctx.control_readings["program"] = got
    return [(name, got[name], lim) for name, lim in ctx.limits.items()]
