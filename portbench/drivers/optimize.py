"""The optimize stage's traffic: a closed loop over the train split, one
fused step a batch, as ``train/optimize.py::run_optimize`` makes it.

Set-up makes the calls ``run_optimize`` makes, in its order:
``OptimizeModels`` (with the benchmark's seeded weights loaded), two
``AdamWithClip``, ``make_optimize_steps``, ``GraphedFusedStep`` over
``DevicePrefetcher(MegaBatches(make_batches(...)))``, the validation runner,
``BestKeeper`` on an ``AsyncSaver``. It then drives that one training object
through its first ``check_steps`` steps through the window's own call and
feed, records what the reference will check, and warms the validation
graph with a pass over the dev split. A branch's first call (D applied or
not) runs eagerly and captures its graph; every later call replays it, as
every call in the window does. So the tokens judged are those of the first
replay of each branch (steps 3 and 5 at ``d_update_every`` 4), read from
the straight-through decode the graph writes, and the change and Adam's
moments are read after the D-apply branch's first replay.
The window goes on with the same object from the next batch: epochs end
with a validation pass and the asynchronous best-G save, with no early
stop. Every step that finished inside the window counts.

After the window the program is freed and the plain reference follows the
first steps from the same weights, batches and generator seeds.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

from portbench.counts import flops
from portbench.lib import harness
from portbench.reference import compare
from portbench.reference import optimize as ref_opt

BETA1 = 0.9
# the generator's table of input embeddings: the rows of the batches' tokens
INPUT_TABLE = "generator.token_embedding.weight"
MODULES = (("generator", "generator"), ("classifier", "classifier"), ("matcher", "matcher"),
           ("lm", "nt_checker"), ("disc", "disc"))


def run(ctx: harness.Context) -> harness.Outcome:
    from consistent__style_transfer_torch.data.pipeline import MegaBatches, make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.train.common import get_corpus, rank_generators
    from consistent__style_transfer_torch.train.graphs import step_runner
    from consistent__style_transfer_torch.train.loop import validate
    from consistent__style_transfer_torch.train.optimize import (VAL_INPUTS, GraphedFusedStep,
                                                                 OptimizeModels,
                                                                 make_optimize_steps)
    from consistent__style_transfer_torch.train.state import AdamWithClip, AsyncSaver, BestKeeper

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    cfg = harness.port_config(ctx)
    tok = harness.tokenizer(cfg)
    models = OptimizeModels(cfg, c["vocab_size"], dev)
    weights = harness.seeded_weights(c, ctx.seed, dev)
    for name, attr in MODULES:
        getattr(models, attr).load_state_dict(weights[name], strict=True)
    del weights
    for m in (models.classifier, models.matcher, models.nt_checker):
        m.requires_grad_(False)
    g_opt = AdamWithClip(models.generator.parameters(), cfg.optimize_lr, cfg.optimize_clip)
    d_opt = AdamWithClip(models.disc.parameters(), cfg.optimize_lr, cfg.optimize_clip)
    steps = make_optimize_steps(cfg, models, g_opt, d_opt)
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    generator, coin_generator = rank_generators(cfg.seed, dev, None)
    d_generator, _ = rank_generators(cfg.seed + 1, dev, None)
    copy_scale = torch.ones((), device=dev)
    if cuda:
        run_step = GraphedFusedStep(steps.fused_step, acc, generator, d_generator, copy_scale,
                                    coin_generator=coin_generator)
    else:
        def run_step(batch, do_apply):
            return steps.fused_step(batch, acc, do_apply, generator, d_generator, copy_scale,
                                    coin_generator=coin_generator)
    run_val = step_runner(lambda inputs, _: [steps.val_step(inputs)], dev)
    B, k, every = cfg.batch_size, cfg.megastep_k, cfg.d_update_every
    train_it = make_batches(get_corpus(cfg, "train", tok), B, cfg.max_len, "optimize",
                            shuffle=True, seed=cfg.seed)
    dev_batches = list(make_batches(get_corpus(cfg, "dev", tok), B, cfg.max_len, "optimize",
                                    shuffle=False, seed=cfg.seed))
    saver = AsyncSaver()
    keeper = BestKeeper(saver=saver)
    dump = os.path.join(ctx.tmp_dir, "optimize")
    os.makedirs(dump, exist_ok=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def epochs():
        """(stacked batch on the device, host arrays) of every group of k
        batches, epoch after epoch; None at each epoch's end."""
        while True:
            for batch, stacked in DevicePrefetcher(MegaBatches(train_it, k), dev):
                yield stacked, batch.arrays
            yield None

    feed = epochs()
    cap = int(t.get("max_steps", 20000))
    g_loss = torch.zeros(cap, device=dev)
    d_loss = torch.zeros(cap, device=dev)
    state = {"n": 0, "ep_steps": 0, "epoch": 0, "val": 0, "saves": 0}

    cur = {"apply": None, "seen": False}

    def group(first_batches=None, on_step=None):
        """One group of k batches through the step; returns the steps run,
        or 0 at an epoch's end (after its validation and save)."""
        a = time.perf_counter()
        item = next(feed)
        b = time.perf_counter()
        ctx.span("data_wait", a, b)
        if item is None:
            end_of_epoch()
            return 0
        stacked, arrays = item
        for i in range(stacked["x"].shape[0]):
            do_apply = state["ep_steps"] % every == 0
            cur.update(apply=do_apply, seen=False)
            a = time.perf_counter()
            aux, dl = run_step({key: v[i] for key, v in stacked.items()}, do_apply)
            b = time.perf_counter()
            ctx.span("dispatch", a, b)
            n = state["n"]
            g_loss[n].copy_(aux["loss"])
            d_loss[n].copy_(dl)
            if first_batches is not None:
                first_batches.append((arrays["x"][i].copy(), arrays["labels"][i].copy()))
            if on_step is not None:
                on_step(n, do_apply)
            state["n"] += 1
            state["ep_steps"] += 1
        a = time.perf_counter()
        sync()
        ctx.span("step_sync", a, time.perf_counter())
        return stacked["x"].shape[0]

    def end_of_epoch():
        a = time.perf_counter()
        val = validate(dev_batches, run_val, dev, inputs=VAL_INPUTS)[0]
        state["saves"] += keeper.update(val, models.generator,
                                        os.path.join(dump, f"G_epoch_{state['epoch']}.pth"),
                                        delete_previous=True)
        state["epoch"] += 1
        state["ep_steps"] = 0
        state["val"] += 1
        ctx.span("validation_and_save", a, time.perf_counter())

    # ---- set-up: the first steps, which the reference follows
    check_steps = int(t["check_steps"])
    first_batches, first_grads, after = [], {}, {}
    # per branch, the straight-through decode (L, B, V) of the G step: on the
    # card the tensor its graph writes at every replay, held from the capture
    held, calls, produced = {}, {}, {}

    def hold_decode(module, args, kwargs, output):
        if kwargs.get("mode") != "st":
            return
        if cuda:  # the capture's first decode is the G step's; D's fresh one follows
            if torch.cuda.is_current_stream_capturing() and cur["apply"] not in held:
                held[cur["apply"]] = output
        elif not cur["seen"]:
            held[cur["apply"]] = output
            cur["seen"] = True

    def on_step(n, do_apply):
        calls[do_apply] = calls.get(do_apply, 0) + 1
        if calls[do_apply] == 2:  # the branch's first replay
            produced[n] = held[do_apply].detach().argmax(-1).t().to("cpu", copy=True)
        if n == 0:
            sync()
            for prefix, opt, module in (("generator", g_opt, models.generator),
                                        ("disc", d_opt, models.disc)):
                for key, p in module.named_parameters():
                    # Adam's first moment after one step is (1 - beta1) g; a
                    # step that never reached Adam leaves no moment: g = 0
                    m1 = opt.adam.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    first_grads[f"{prefix}.{key}"] = (m1 / (1 - BETA1)).cpu()

    hook = models.generator.register_forward_hook(hold_decode, with_kwargs=True)
    while state["n"] < check_steps:
        group(first_batches, on_step)
    hook.remove()
    if len(produced) < 2:
        raise ValueError(f"check_steps {check_steps} must reach the first replay of each "
                         f"branch; the first replays were steps {sorted(produced)}")
    held.clear()
    sync()
    for prefix, module in (("generator", models.generator), ("disc", models.disc)):
        for key, p in module.named_parameters():
            after[f"{prefix}.{key}"] = p.detach().to("cpu", copy=True)
    first_losses = list(zip(g_loss[:check_steps].tolist(), d_loss[:check_steps].tolist()))
    val_prog = validate(dev_batches, run_val, dev, inputs=VAL_INPUTS)[0]  # captures its graph
    sync()

    # ---- the window
    readings = {}
    trace_from, trace_steps = int(t["trace_from"]), int(t["trace_steps"])
    tracer, trace, mark = None, None, {}

    def stop_trace():
        readings.update(trace_steps=state["n"] - mark["n"],
                        trace_val_passes=state["val"] - mark["val"])
        return tracer.stop()

    start_n, val_open, saves_open = state["n"], state["val"], state["saves"]
    t_open = ctx.open_window()
    while time.perf_counter() - t_open < ctx.seconds:
        if ctx.trace and tracer is None and state["n"] - start_n >= trace_from:
            from portbench.lib.trace import Tracer

            tracer = Tracer()
            tracer.start()
            mark = {"n": state["n"], "val": state["val"]}
        group()
        if tracer is not None and trace is None and state["n"] - mark["n"] >= trace_steps:
            trace = stop_trace()
    if tracer is not None and trace is None:
        trace = stop_trace()
    window_s = time.perf_counter() - t_open
    n_window = state["n"] - start_n
    losses = torch.stack([g_loss[start_n:state["n"]], d_loss[start_n:state["n"]]])
    failed = int((~torch.isfinite(losses)).any(dim=0).sum())
    saver.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    e2e = {"optimize_sent_per_s": n_window * B / window_s}
    report_window(ctx, t_open, window_s, n_window, state["val"] - val_open,
                  state["saves"] - saves_open)
    readings.update(window=(t_open, t_open + window_s), window_s=window_s, steps=n_window,
                    val_passes=state["val"], step_flops=flops.optimize_step(c),
                    val_flops=flops.validation_batch(c) * len(dev_batches))

    # ---- free the program, then the reference
    del run_step, run_val, steps, models, g_opt, d_opt, acc, feed, g_loss, d_loss
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check(ctx, first_batches[:check_steps], first_losses, first_grads, after, val_prog,
                   dev_batches, cfg.seed, produced)
    return harness.Outcome(e2e, n_window, failed, checks, readings, memory_peak, trace)


def check(ctx, batches, losses, grads, after, val_prog, dev_batches, seed: int, tokens: dict):
    """The reference's first steps and validation from the same weights,
    batches and generator seeds, against the program's: (name, value,
    limit) for each number in the cell's limits. ``tokens``: {step: the ids
    its transfer produced} for the steps judged. With ``ctx.control`` the
    readings of the control (the reference in fp8 in the program's place)
    and of the planted faults go to ``ctx.control_readings``, each with
    the compared numbers it fails."""
    c, dev = ctx.config, ctx.device
    on_dev = [(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)) for x, y in batches]
    dev_b = dev_arrays(dev_batches, dev)
    judged = tuple(sorted(tokens))

    def follow(fault=None, products=None):
        m = harness.reference_modules(c, ctx.seed, dev)
        gen = torch.Generator(dev).manual_seed(seed)
        d_gen = torch.Generator(dev).manual_seed(seed + 1)
        with products or contextlib.nullcontext():
            out = ref_opt.first_steps(m, c, on_dev, gen, d_gen, fault, judged)
            out["val"] = ref_opt.validation_loss(m, c, dev_b)
        return out

    ref = follow()
    init = {f"{name}.{k}": v.cpu() for name, state in
            harness.seeded_weights(c, ctx.seed, dev, names=("generator", "disc")).items()
            for k, v in state.items()}
    judge = harness.reference_modules(c, ctx.seed, dev)

    def readings(p_losses, p_grads, p_after, p_val, p_tokens):
        out = compare.training_gaps(p_losses, p_grads, p_after, ref, init)
        out["val_gap"] = compare.relative_gap(p_val, ref["val"])
        gaps, missing = [], 0
        for i in judged:
            x, labels = on_dev[i]
            gaps.append(ref_opt.token_gap(judge, c, x, labels, p_tokens[i].to(dev), ref["at"][i]))
            missing = max(missing, x.shape[0] - p_tokens[i].shape[0])
        out["token_gaps"], out["token_gap"] = gaps, max(gaps)
        out["rows_missing"] = float(missing)
        out["input_rows_unmoved"] = float(compare.rows_left_unmoved(
            p_after[INPUT_TABLE], ref["params"][INPUT_TABLE], init[INPUT_TABLE],
            np.concatenate([x.reshape(-1) for x, _ in batches])))
        return out

    def fails(out):
        return [k for k, lim in ctx.limits.items() if not out[k] <= lim]

    if ctx.control:
        from portbench.reference.lowp import Fp8Products

        for name, kw in (("control", {"products": Fp8Products()}),
                         ("half_batch", {"fault": "half_batch"}),
                         ("half_loss", {"fault": "half_loss"}), ("token", {"fault": "token"})):
            out = follow(**kw)
            got = readings(out["losses"], out["grads"], out["params"], out["val"],
                           out["tokens"])
            ctx.control_readings[name] = {**got, "fails": fails(got)}
        got = readings(ref["losses"], ref["grads"], init, ref["val"], ref["tokens"])
        ctx.control_readings["unchanged"] = {**got, "fails": fails(got)}
    got = readings(losses, grads, after, val_prog, tokens)
    if ctx.control:
        ctx.control_readings["program"] = got
    return [(name, got[name], lim) for name, lim in ctx.limits.items()]


def report_window(ctx, t_open: float, window_s: float, steps: int, epochs: int, saves: int):
    """Where the window's time went, on standard error: its steps, epoch
    ends and best-G saves, and the host's spans a step."""
    total = {}
    for name, a, b in ctx.spans:
        if t_open <= a < t_open + window_s:
            total[name] = total.get(name, 0.0) + (b - a)
    per_step = ", ".join(f"{k} {v / max(steps, 1) * 1e3:.3f}" for k, v in sorted(total.items()))
    print(f"portbench: window {window_s:.3f} s, {steps} steps, {epochs} epoch ends, {saves} "
          f"saves; ms a step: {per_step}", file=sys.stderr, flush=True)


def dev_arrays(dev_batches, dev):
    """(x, labels, row_mask) of each dev batch on ``dev``: the real rows
    are the first ``valid``."""
    out = []
    for b in dev_batches:
        rows = (np.arange(len(b["labels"])) < b.valid).astype(np.float32)
        out.append((torch.as_tensor(b["x"], device=dev), torch.as_tensor(b["labels"], device=dev),
                    torch.as_tensor(rows, device=dev)))
    return out
