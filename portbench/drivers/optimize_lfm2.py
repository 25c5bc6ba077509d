"""The optimize stage's traffic with the LFM2-8B-A1B generator
(``--backbone lfm2_moe``): a closed loop over the train split, one fused
step a batch, as ``train/optimize.py::run_optimize`` makes it.

The loop, the window and the epoch ends are ``drivers/optimize.py``'s:
``OptimizeModels``, two ``AdamWithClip``, ``make_optimize_steps``,
``GraphedFusedStep`` over ``DevicePrefetcher(MegaBatches(...))``, the
graphed validation and the asynchronous best-G save, with the
configuration's generator (the first ``num_hidden_layers`` of its
``layer_types``, at the widths the port publishes, which must be the
configuration's). The scorers and D take the seeded weights
``yelp.optimize`` gives them at the same seed; the generator takes its own
(``reference/lfm2_moe.py::seeded_state``).

What is judged is read from the graphs' replays. Each branch (D applied
or not) first runs once, which on the card runs it eagerly and captures
its graph. Then the parameters, Adam's moments and step counts, D's
gradient sum and the generators go back to their seeded state twice:
step 0 runs the D-held branch alone from it, and steps 1 to
``check_steps`` run from it again, the D-apply branch first, every step
a replay on the card. So the first replay of each branch (steps 0 and 1)
starts from the seeded weights, which the reference shares: the ids its
graph produced (the argmax of the straight-through transfer its graph
hands D) are judged by the reference's logits from those weights, and
its expert selections against the reference's own (``route_flip_pct``).
The change of G and D after steps 1 to ``check_steps``, and the rows of
G's embedding that moved, are judged against the reference's steps. The
reference follows the program's path (``reference/lfm2_moe.py``, "The
program's path"): every expert layer's selection at every call of those
steps and the tokens each decode fed back (the argmax of the transfers D
scored), read from the hooks on the routers and on D, from each graph's
capture.

Readings for the per-layer metrics: each expert layer's routed rows per
expert over the window (its device ``load``, zeroed as the window opens,
read after it closes), the step's FLOPs (``counts/moe.py``: routed rows at
T x k) and the least time of its grouped expert products.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

from portbench.counts import moe as moe_counts
from portbench.drivers import optimize as base
from portbench.lib import harness
from portbench.reference import compare
from portbench.reference import lfm2_moe as ref_lfm2
from portbench.reference import models as ref_models

SCORERS = ("classifier", "matcher", "lm", "disc")
PORT_WIDTHS = dict(d_model="d", n_heads="H", n_kv_heads="KV", head_dim="hd", d_ff="ff",
                   d_expert="fe", n_experts="E", top_k="k", n_dense="n_dense",
                   conv_width="W", rope_theta="theta", norm_eps="eps")


def check_widths(c: dict) -> None:
    """The port builds its published widths; they must be the
    configuration's."""
    from consistent__style_transfer_torch.models import lfm2_moe

    w = ref_lfm2.widths(c)
    differ = {k: (lfm2_moe.PUBLISHED[k], w[ours]) for k, ours in PORT_WIDTHS.items()
              if lfm2_moe.PUBLISHED[k] != w[ours]}
    if differ or tuple(lfm2_moe.LAYER_TYPES[:len(w["kinds"])]) != w["kinds"]:
        raise ValueError(f"the port's LFM2 widths differ from the configuration's: {differ}")


def route_tables(calls: list, B: int, L: int, n: int) -> dict:
    """One step's router selections, in call order, as per-call tables
    (n expert layers, B, 2L positions, k): G's decode (its source pass,
    then L cached steps), its back-translation pass, D's decode."""
    per_decode = n + L * n
    if len(calls) != 2 * per_decode + n:
        raise ValueError(f"{len(calls)} router calls in a step; expected {2 * per_decode + n}")

    def decode(cs):
        source = torch.stack([c.view(B, L, -1) for c in cs[:n]])
        steps = torch.stack([torch.stack(cs[n + t * n:n + (t + 1) * n]) for t in range(L)], 2)
        return torch.cat([source, steps], 2)

    bt = torch.stack([c.view(B, 2 * L, -1) for c in calls[per_decode:per_decode + n]])
    return {"g_st": decode(calls[:per_decode]), "g_bt": bt,
            "d_st": decode(calls[per_decode + n:])}


def run(ctx: harness.Context) -> harness.Outcome:
    from consistent__style_transfer_torch.data.pipeline import MegaBatches, make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.models.moe import Router, SparseMoE, recomputing
    from consistent__style_transfer_torch.train.common import get_corpus, rank_generators
    from consistent__style_transfer_torch.train.graphs import step_runner
    from consistent__style_transfer_torch.train.loop import validate
    from consistent__style_transfer_torch.train.optimize import (VAL_INPUTS, GraphedFusedStep,
                                                                 OptimizeModels,
                                                                 make_optimize_steps)
    from consistent__style_transfer_torch.train.state import AdamWithClip, AsyncSaver, BestKeeper

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    cfg = harness.port_config(ctx, backbone="lfm2_moe", lfm2_layers=c["num_hidden_layers"])
    check_widths(c)
    tok = harness.tokenizer(cfg)
    V = c["vocab_size"]
    models = OptimizeModels(cfg, V, dev)
    weights = harness.seeded_weights(moe_counts.scorer_config(c), ctx.seed, dev, names=SCORERS)
    for name, attr in base.MODULES[1:]:
        getattr(models, attr).load_state_dict(weights[name], strict=True)
    models.generator.load_state_dict(ref_lfm2.seeded_state(c, V, ctx.seed, dev), strict=True)
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
    B, k, every, L = cfg.batch_size, cfg.megastep_k, cfg.d_update_every, cfg.max_len
    train_it = make_batches(get_corpus(cfg, "train", tok), B, L, "optimize", shuffle=True,
                            seed=cfg.seed)
    dev_batches = list(make_batches(get_corpus(cfg, "dev", tok), B, L, "optimize",
                                    shuffle=False, seed=cfg.seed))
    saver = AsyncSaver()
    keeper = BestKeeper(saver=saver)
    dump = os.path.join(ctx.tmp_dir, "optimize")
    os.makedirs(dump, exist_ok=True)
    moes = [m for m in models.generator.modules() if isinstance(m, SparseMoE)]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def epochs():
        while True:
            for batch, stacked in DevicePrefetcher(MegaBatches(train_it, k), dev):
                yield stacked, batch.arrays
            yield None

    feed = epochs()
    cap = int(t.get("max_steps", 20000))
    g_loss = torch.zeros(cap, device=dev)
    d_loss = torch.zeros(cap, device=dev)
    state = {"n": 0, "ep_steps": 0, "epoch": 0, "val": 0, "saves": 0}
    cur = {"apply": None, "seen": set()}

    def group(first_batches=None, on_step=None):
        a = time.perf_counter()
        item = next(feed)
        ctx.span("data_wait", a, time.perf_counter())
        if item is None:
            end_of_epoch()
            return 0
        stacked, arrays = item
        for i in range(stacked["x"].shape[0]):
            do_apply = state["ep_steps"] % every == 0
            cur["apply"] = do_apply
            cur["seen"].add(do_apply)
            if on_step is not None:
                on_step(None, do_apply)  # the step starts
            a = time.perf_counter()
            aux, dl = run_step({key: v[i] for key, v in stacked.items()}, do_apply)
            ctx.span("dispatch", a, time.perf_counter())
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

    # ---- set-up: both branches captured, then the first steps from the
    # seeded state, which the reference follows
    check_steps = int(t["check_steps"])
    params = list(models.generator.parameters()) + list(models.disc.parameters())
    gens = [g for g in (generator, d_generator, coin_generator) if g is not None]
    seeded = ([p.detach().to("cpu", copy=True) for p in params], [g.get_state() for g in gens])
    # the judged steps, the first of each branch from the seeded state:
    # {step: the dropout generator's state as it starts}
    first_batches, routes, feeds, judged, branches = [], [], [], {}, set()
    # per step, every router's selection and the soft transfers D scores
    # (G's and then D's own decode, whose argmax are the tokens each fed
    # back): a step's eager outputs, and per branch the tensors its capture
    # holds, which each replay writes
    eager = {"routes": [], "probs": []}
    held = {}

    def capturing():
        return cuda and torch.cuda.is_current_stream_capturing()

    def keep(kind, tensor):
        if capturing():
            held.setdefault(cur["apply"], {"routes": [], "probs": []})[kind].append(tensor)
        else:
            eager[kind].append(tensor.detach().clone())

    def hold_route(module, args, output):
        if not recomputing():  # a checkpointed layer's forward again, in the backward
            keep("routes", output[1])

    def hold_probs(module, args, output):
        if torch.is_floating_point(args[0]):  # a transfer, not the real batch's ids
            keep("probs", args[0])

    def on_capture(n, do_apply):
        if n is None:
            eager["routes"].clear()
            eager["probs"].clear()

    def on_step(n, do_apply):
        on_capture(n, do_apply)
        if n is None:  # a step starts: a branch's first from the seeded state is judged
            if do_apply not in branches:
                branches.add(do_apply)
                judged[state["n"]] = generator.get_state()
            return
        got = held[do_apply] if cuda else eager  # on the card every step here replays
        routes.append(route_tables([r.clone() for r in got["routes"]], B, L, len(moes)))
        g_probs, d_probs = got["probs"]
        feeds.append({"g_st": g_probs.argmax(-1), "d_st": d_probs.argmax(-1)})

    hooks = [m.register_forward_hook(hold_route) for m in models.generator.modules()
             if isinstance(m, Router)]
    hooks.append(models.disc.register_forward_hook(hold_probs))
    def restore():
        """Back to the seeded state: weights, Adam, D's sum, generators."""
        sync()
        with torch.no_grad():
            for p, v in zip(params, seeded[0]):
                p.copy_(v)
            for opt in (g_opt, d_opt):
                for st in opt.adam.state.values():
                    for v in st.values():
                        if torch.is_tensor(v):
                            v.zero_()
            for a in acc:
                a.zero_()
        for g, v in zip(gens, seeded[1]):
            g.set_state(v)

    while cur["seen"] != {True, False}:  # each branch's first call: on the card, its capture
        group(on_step=on_capture)
    # step 0: the D-held branch alone from the seeded state; then steps 1 to
    # check_steps from it again, the D-apply branch first
    restore()
    state.update(n=0, ep_steps=1)
    group(first_batches, on_step)
    restore()
    state.update(ep_steps=0)
    while state["n"] < check_steps + 1:
        group(first_batches, on_step)
    del seeded
    for h in hooks:
        h.remove()
    if branches != {True, False}:
        raise ValueError(f"check_steps {check_steps} must reach both branches; "
                         f"the steps were {sorted(judged)}")
    held.clear()
    sync()
    routes = [{key: v.cpu() for key, v in r.items()} for r in routes[:check_steps + 1]]
    feeds = [{key: v.cpu() for key, v in f.items()} for f in feeds[:check_steps + 1]]
    after = {f"{prefix}.{key}": p.detach().to("cpu", copy=True)
             for prefix, module in (("generator", models.generator), ("disc", models.disc))
             for key, p in module.named_parameters()}
    validate(dev_batches, run_val, dev, inputs=VAL_INPUTS)  # captures its graph
    sync()

    # ---- the window
    readings = {}
    trace_from, trace_steps = int(t["trace_from"]), int(t["trace_steps"])
    tracer, trace, mark = None, None, {}

    def stop_trace():
        readings.update(trace_steps=state["n"] - mark["n"],
                        trace_val_passes=state["val"] - mark["val"])
        return tracer.stop()

    for m in moes:
        m.load.zero_()
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
    base.report_window(ctx, t_open, window_s, n_window, state["val"] - val_open,
                       state["saves"] - saves_open)
    readings.update(window=(t_open, t_open + window_s), window_s=window_s, steps=n_window,
                    val_passes=state["val"], step_flops=moe_counts.optimize_step(c),
                    val_flops=moe_counts.validation_batch(c) * len(dev_batches),
                    moe_load=[m.load.tolist() for m in moes],
                    gmm_bound_ms=moe_counts.gmm_bound_ms(c))

    # ---- free the program, then the reference
    del run_step, run_val, steps, models, params, gens, g_opt, d_opt, acc, feed, g_loss, d_loss
    del moes, generator, d_generator, coin_generator
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check(ctx, first_batches[:check_steps + 1], routes, feeds, after, cfg.seed, judged)
    return harness.Outcome(e2e, n_window, failed, checks, readings, memory_peak, trace)


def reference_modules(ctx: harness.Context) -> dict:
    """The plain reference's modules with the seeded weights, float32, TF32
    off: the scorers and D of ``reference/models.py``, the generator of
    ``reference/lfm2_moe.py``."""
    c, dev = ctx.config, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = moe_counts.scorer_config(c)
    m = {name: mod for name, mod in ref_models.build(sc, dev).items() if name in SCORERS}
    for name, state in harness.seeded_weights(sc, ctx.seed, dev, names=SCORERS).items():
        m[name].load_state_dict(state, strict=True)
    m["generator"] = ref_lfm2.build(c, c["vocab_size"], dev)
    m["generator"].load_state_dict(ref_lfm2.seeded_state(c, c["vocab_size"], ctx.seed, dev),
                                   strict=True)
    return m


def check(ctx, batches, routes, feeds, after, seed: int, judged: dict):
    """The program's steps against the plain reference's from the same
    seeded weights, batches and generator seeds: (name, value, limit) for
    each number in the cell's limits. ``batches``, ``routes`` and
    ``feeds``: per step, the program's batch, every expert layer's
    selection at every call and the tokens each decode fed back; step 0
    ran alone from the seeded state, steps 1 on from it again. The judged
    steps (``judged``: {step: the program's dropout generator state as it
    starts}, both from the seeded state) are judged by the reference's
    logits along the program's path from the seeded weights
    (``reference/lfm2_moe.py::judge``): the ids the program fed back, and
    in ``route_flip_pct`` its selections against the reference's own. The
    change after the steps from 1 on, and the input rows moved, are judged
    against the reference's steps along the same path. With
    ``ctx.control`` the readings of the control (the generator's products
    in fp8, the scorers' through ``lowp.Fp8Products``) and of the planted
    faults, each along the same path, go to ``ctx.control_readings``, each
    with the compared numbers it fails."""
    c, dev = ctx.config, ctx.device
    on_dev = [(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
              for x, y in batches]
    routes_dev = [{key: v.to(dev) for key, v in r.items()} for r in routes]
    feeds_dev = [{key: v.to(dev) for key, v in f.items()} for f in feeds]
    steps = tuple(sorted(judged))
    rows = torch.as_tensor(np.unique(np.concatenate([x.reshape(-1) for x, _ in batches[1:]])),
                           device=dev).long()
    variants = {"control": {"fp8": True}, "top3": {"fault": "top3"},
                "conv_shift": {"fault": "conv_shift"}, "half_batch": {"fault": "half_batch"}}

    # the judged steps, from the seeded weights, for the sound reference
    # and, with the control, for each variant
    torch.backends.cuda.matmul.allow_tf32 = False
    G = ref_lfm2.build(c, c["vocab_size"], dev)
    G.load_state_dict(ref_lfm2.seeded_state(c, c["vocab_size"], ctx.seed, dev), strict=True)
    at = {i: (*on_dev[i], feeds_dev[i]["g_st"], routes_dev[i]["g_st"], judged[i])
          for i in steps}
    sound_judged = ref_lfm2.judge(G, at)
    path = {i: logits for i, (logits, _) in sound_judged.items()}
    own = {i: o for i, (_, o) in sound_judged.items()}
    seen = {}
    if ctx.control:
        for name, kw in variants.items():
            seen[name] = {i: (logits.argmax(-1), o)
                          for i, (logits, o) in ref_lfm2.judge(G, at, **kw).items()}
    del G, sound_judged

    def follow(fault=None, fp8=False, sound=False):
        m = reference_modules(ctx)
        m["generator"].fp8 = fp8
        gen = torch.Generator(dev).manual_seed(seed)
        d_gen = torch.Generator(dev).manual_seed(seed + 1)
        products = contextlib.nullcontext()
        if fp8:
            from portbench.reference.lowp import Fp8Products

            products = Fp8Products()
        with products:
            out = ref_lfm2.first_steps(m, c, on_dev[1:], routes_dev[1:], feeds_dev[1:], gen,
                                       d_gen, fault, sound)
        del m
        return out

    init = {f"generator.{key}": v.cpu() for key, v in
            ref_lfm2.seeded_state(c, c["vocab_size"], ctx.seed, dev).items()}
    init.update({f"disc.{key}": v.cpu() for key, v in harness.seeded_weights(
        moe_counts.scorer_config(c), ctx.seed, dev, names=("disc",))["disc"].items()})
    ref = follow(sound=True)
    keep = ref.pop("keep")

    def summary(params):
        """What a run's leaves after the steps are compared by: the norm of
        each moving leaf's change, and the input table's rows moved."""
        def change(key):
            return params[key].to(dev) - init[key].to(dev)

        return {"change": {key: torch.linalg.vector_norm(change(key)[mask].double()).cpu()
                           for key, mask in keep.items()},
                "moved": change(base.INPUT_TABLE)[rows].abs().amax(-1) > 0}

    sound = summary(ref.pop("params"))
    del ref

    def flips(selection):
        """The judged steps' token-layer pairs of G's transfer whose experts
        in ``selection`` ({step: (n_moe, b, 2L, k)}) differ from the sound
        reference's own there."""
        n = [ref_lfm2.differs(selection[i].to(dev).reshape(-1, own[i].shape[-1]),
                              own[i][:, :selection[i].shape[1]].reshape(-1, own[i].shape[-1]))
             for i in steps]
        return float(torch.cat(n).float().mean())

    def readings(run, tokens, selection):
        out = dict(zip(("change_gap", "change_leaf"),
                       compare.worst_leaf_gap(run["change"], sound["change"])))
        gaps = [compare.logit_gap(path[i][:tokens[i].shape[0]], tokens[i].to(dev))
                for i in steps]
        out["token_gaps"], out["token_gap"] = gaps, max(gaps)
        out["rows_missing"] = float(max(on_dev[i][0].shape[0] - tokens[i].shape[0]
                                        for i in steps))
        out["input_rows_unmoved"] = float((sound["moved"] & ~run["moved"]).sum())
        out["route_flip_pct"] = 100.0 * flips(selection)
        return out

    def fails(out):
        return [key for key, lim in ctx.limits.items() if not out[key] <= lim]

    if ctx.control:
        for name, kw in variants.items():
            gc.collect()
            out = summary(follow(**kw)["params"])
            got = readings(out, {i: t for i, (t, _) in seen[name].items()},
                           {i: o for i, (_, o) in seen[name].items()})
            ctx.control_readings[name] = {**got, "fails": fails(got)}
        got = readings(summary(init), {i: path[i].argmax(-1) for i in steps}, own)
        ctx.control_readings["unchanged"] = {**got, "fails": fails(got)}
    got = readings(summary(after), {i: feeds[i]["g_st"] for i in steps},
                   {i: routes[i]["g_st"] for i in steps})
    print(f"judged steps {steps}: token_gaps {got['token_gaps']}; change_gap's worst leaf "
          f"{got['change_leaf']}", file=sys.stderr)
    if ctx.control:
        ctx.control_readings["program"] = got
    return [(name, got[name], lim) for name, lim in ctx.limits.items()]
