"""Pretrain stage: jointly train the three scorers that later stages freeze,
the port of the JAX package's ``train/pretrain.py`` (reference
``src/main_pretrain.py``):

- TextCNN style classifier: CE(cls(x), style label);
- PairMatcher: MSE(matcher(noise1, noise2), WMD label) on two independent
  transfer_noise(0.15) variants, the label from the Sinkhorn kernel
  (``data/wmd_labels.py``) on the card;
- TransformerLM denoiser: CE(LM(rand_perm(x)), x).

One Adam(1e-4) over all three towers behind a *joint* global-norm clip of 5.0
(``main_pretrain.py:61-64``), summed losses (``main_pretrain.py:66-77``).
Per-task freeze-on-plateau (``main_pretrain.py:92-110``): the first time a
task's val loss worsens, its flag turns off for good; its tower is no longer
run, and its best weights stay on disk. A frozen tower still takes Adam steps
on zero gradients, as under optax (``train/state.py::AdamWithClip``). The
early-stopping val_loss is the sum of per-task bests, patience 1. Existing
per-task dumps ``dump/<ds>/pretrain/{cls,mat,dn}.pth`` are resumed from.

Parameters stay float32; with ``dtype="bfloat16"`` the towers run under
``torch.autocast`` in bfloat16. Dropout is on in train steps and off in eval
steps, its masks drawn from one seeded ``torch.Generator`` on the device.

On the card every train step replays a CUDA graph of the step, one per
flag tuple (``train/graphs.py::GraphedStep``), as the JAX package compiles
one program per ``flags``; its static inputs are the batch keys the flags
read (:func:`step_inputs`), so ``nx1``, ``nx2`` and ``wmd`` go once the
matcher freezes. The WMD labels, and so the Sinkhorn kernel, stay in the
collate on the prefetcher's thread, outside the graph. A tower freezes at
an epoch's end, so the next flag tuple is captured at the next epoch's
first step, while the per-task best saves of that epoch end may still be
copying to the host on the saver's thread: the capture waits for them
first. Validation stays eager. On the CPU the same loop runs the step
eagerly.

Under the launcher (``parallel/``) each data rank takes its rows of every
batch, labels only those pairs (one Sinkhorn launch a batch on ``B/D``
pairs), and the optimizer averages the gradients over the data group before
the clip; validation adds up every rank's masked sums and counts, so all
ranks take the same freeze and stop decisions. Rank 0 saves and logs.
"""

from __future__ import annotations

import os

import torch

from ..config import Config
from ..data.pipeline import make_batches
from ..data.prefetch import DevicePrefetcher
from ..data.wmd_labels import ExactWmdLabeler, SinkhornWmdLabeler
from ..ops.losses import cross_entropy, mse, softmax_cross_entropy_tokens
from ..parallel.mesh import barrier, is_main
from ..parallel.sharding import batch_sharding, data_group, global_means, replicate
from ..utils.io import RunLogger
from ..utils.profiling import read_device_times, span
from .common import (
    autocast,
    build_classifier,
    build_lm,
    build_matcher,
    compute_dtype,
    get_corpus,
    get_device,
    get_mesh,
    get_tokenizer,
    get_w2v,
    rank_generators,
)
from .graphs import step_runner
from .loop import EarlyStopper, Throughput, clock_of, validate
from .state import AdamWithClip, AsyncSaver, load_state_dict, params_exist, save_state_dict

TASKS = ("cls", "mat", "dn")
# the batch keys each tower's loss reads (see make_pretrain_steps)
TASK_INPUTS = {"cls": ("x", "labels"), "mat": ("nx1", "nx2", "wmd"), "dn": ("nx3", "x")}


def step_inputs(flags) -> tuple[str, ...]:
    """The batch keys a train step with the (cls, mat, dn) ``flags`` reads."""
    keys = [k for t, on in zip(TASKS, flags) if on for k in TASK_INPUTS[t]]
    return tuple(dict.fromkeys(keys))


def make_pretrain_steps(models: dict, optimizer: AdamWithClip,
                        autocast_dtype: torch.dtype | None = None):
    """(train_step, eval_step) over ``models`` {"cls", "mat", "dn"}.

    ``train_step(batch, flags, generator)`` runs the flagged towers in train
    mode (dropout from ``generator``), back-propagates the summed loss, takes
    one clipped Adam step and returns the per-task losses from before the
    update. ``eval_step(batch, flags)`` returns them in eval mode, without
    gradients. ``batch`` is a dict of tensors on the models' device; an
    optional ``row_mask`` keeps padded duplicate rows out of the means.
    ``flags`` is a (cls, mat, dn) tuple of bools."""
    cls_m, mat_m, dn_m = models["cls"], models["mat"], models["dn"]
    dtype = torch.float32 if autocast_dtype is None else autocast_dtype
    device = next(cls_m.parameters()).device

    def losses(batch, flags, generator):
        rows = batch.get("row_mask")
        out = {}
        with autocast(device, dtype):
            if flags[0]:
                out["cls"] = cross_entropy(cls_m(batch["x"], generator), batch["labels"],
                                           mask=rows)
            if flags[1]:
                out["mat"] = mse(mat_m(batch["nx1"], batch["nx2"], generator), batch["wmd"],
                                 mask=rows)
            if flags[2]:
                out["dn"] = softmax_cross_entropy_tokens(dn_m(batch["nx3"], generator),
                                                         batch["x"], row_mask=rows)
        return out

    def train_step(batch, flags, generator=None):
        for m in models.values():
            m.train()
        optimizer.zero_grad()
        parts = losses(batch, flags, generator)
        sum(parts.values()).backward()
        optimizer.step()
        return {t: v.detach() for t, v in parts.items()}

    @torch.no_grad()
    def eval_step(batch, flags):
        for m in models.values():
            m.eval()
        return losses(batch, flags, None)

    return train_step, eval_step


def run_pretrain(cfg: Config, progress: bool = True) -> dict[str, str]:
    """Returns {task: best checkpoint path}."""
    device = get_device(cfg)
    mesh = get_mesh(cfg, device)
    group, main = data_group(mesh), is_main()
    tokenizer = get_tokenizer(cfg)
    w2v = get_w2v(cfg, tokenizer)
    task_dump = os.path.join(cfg.ds_dump_dir, "pretrain")
    os.makedirs(task_dump, exist_ok=True)
    paths = {t: os.path.join(task_dump, f"{t}.pth") for t in TASKS}

    if cfg.sinkhorn_wmd:
        labeler = SinkhornWmdLabeler(w2v, tokenizer, max_atoms=cfg.max_len + cfg.max_len // 2,
                                     device=device)
    else:
        labeler = ExactWmdLabeler(w2v, tokenizer)

    train_corpus = get_corpus(cfg, "train", tokenizer)
    dev_corpus = get_corpus(cfg, "dev", tokenizer)
    # once the matcher freezes, both iterators skip its inputs (two noise
    # variants and the WMD label) for every remaining epoch
    flags = {t: True for t in TASKS}
    need_matcher = lambda: flags["mat"]  # noqa: E731
    rows = batch_sharding(mesh, cfg.batch_size)  # all of them in one process
    train_it = make_batches(train_corpus, cfg.batch_size, cfg.max_len, "pretrain",
                            shuffle=True, seed=cfg.seed, wmd_labeler=labeler,
                            need_matcher=need_matcher, rows=rows)
    dev_it = make_batches(dev_corpus, cfg.batch_size, cfg.max_len, "pretrain",
                          shuffle=False, seed=cfg.seed, wmd_labeler=labeler,
                          need_matcher=need_matcher, rows=rows)

    V = len(tokenizer)
    models = {"cls": build_classifier(cfg, V, device), "mat": build_matcher(cfg, V, device),
              "dn": build_lm(cfg, V, device)}
    for t in TASKS:  # resume from existing per-task dumps when present
        if params_exist(paths[t]):
            models[t].load_state_dict(load_state_dict(paths[t]), strict=True)
        replicate(models[t], mesh)
    optimizer = AdamWithClip([p for t in TASKS for p in models[t].parameters()],
                             cfg.pretrain_lr, cfg.pretrain_clip, group=group)
    dtype = compute_dtype(cfg)
    train_step, eval_step = make_pretrain_steps(
        models, optimizer, autocast_dtype=dtype if dtype != torch.float32 else None)
    generator, _ = rank_generators(cfg.seed, device, mesh)  # dropout only: no coins here

    logger = RunLogger(f"{cfg.log_dir}/{cfg.dataset}", "pretrain", config=cfg, enabled=main)
    stopper = EarlyStopper(cfg.pretrain_patience)
    best = {t: float("inf") for t in TASKS}
    thru = Throughput()
    saver = AsyncSaver()  # per-task best saves overlap the next epoch
    # a new flag tuple is captured after an epoch end's saves: drain them
    # first, as the saver's host copies must not overlap a capture
    run_step = step_runner(lambda inputs, flags: train_step(inputs, flags, generator), device,
                           (generator,), before_capture=saver.wait, name="pretrain.step")
    run_eval = step_runner(lambda inputs, flags: list(eval_step(inputs, flags).values()), device,
                           before_capture=saver.wait, name="pretrain.eval_step")

    step = 0
    for epoch in range(cfg.epochs):
        ftuple = tuple(flags[t] for t in TASKS)
        if not any(ftuple):
            break
        ep_sent, ep_steps = 0, 0
        keys = step_inputs(ftuple)
        with span("epoch", step=epoch, always=True) as ep:
            for _, arrays in DevicePrefetcher(train_it, device):
                parts = run_step({k: arrays[k] for k in keys}, ftuple)
                thru.add(cfg.batch_size)
                ep_sent += cfg.batch_size
                ep_steps += 1
                if step % 50 == 0:  # reads the losses: a sync every 50 steps
                    with span("log", step=step):
                        parts = global_means(parts, group)
                        logger.log(step, **{f"{t}_loss": v for t, v in parts.items()},
                                   **thru.rates())
                step += 1
            if device.type == "cuda":
                with span("train.sync", step=step):
                    torch.cuda.synchronize(device)
                read_device_times()

        # validation at epoch end, over the real rows (a rank's own rows);
        # eval_step's losses come in TASKS order
        active = [t for t in TASKS if flags[t]]
        with span("validate", step=epoch, always=True) as val_span:
            val = dict(zip(active, validate(dev_it, run_eval, device, mesh, shard=False,
                                            key=ftuple, inputs=(*keys, "row_mask"))))
        ep_rate = ep_sent / max(ep.seconds + val_span.seconds, 1e-6)  # validation included
        with span("save", step=epoch):
            for t in TASKS:
                if not flags[t]:
                    continue
                if best[t] < val[t]:
                    flags[t] = False  # permanent freeze (main_pretrain.py:100-102)
                else:
                    best[t] = val[t]
                    if main:
                        saver.submit(models[t], paths[t])
        val_loss = sum(v for v in best.values() if v != float("inf"))
        with span("log", step=step):
            logger.log(step, val_loss=val_loss, epoch=epoch, epoch_sent_per_s=ep_rate,
                       train_steps=ep_steps, train_s=ep.seconds, val_s=val_span.seconds,
                       **{f"val_{t}": val.get(t, float("nan")) for t in TASKS}, **clock_of(device))
        if progress and main:
            print(f"[pretrain] epoch {epoch} val_loss {val_loss:.4f} "
                  f"{ep_rate:.1f} sent/s flags {flags}")
        if stopper.update(val_loss):
            break

    with span("save"):
        saver.close()  # drain pending saves, re-raising worker errors
    for t in TASKS:  # artifacts exist even after a degenerate run
        if main and not os.path.exists(paths[t]):
            save_state_dict(models[t].state_dict(), paths[t])
    logger.close()
    barrier()  # the dumps are on disk before any rank goes on to read them
    return paths
