"""Warmup stage: train the generator as a denoising autoencoder, the port of
the JAX package's ``train/warmup.py`` (reference ``src/main_warmup.py``):
CE(G(transfer_noise(x, 0.1), label, teacher=x, label), x) in scheduled
sampling, unmasked over every token; Adam lr 1e-3 behind a global-norm clip
of 1.0, one epoch of batch 512, early stopping with patience 1, the best G
saved on a validation improvement as ``dump/<ds>/warmup/G.pth``
(``G_<backbone>.pth`` for another backbone than the LSTM:
:func:`warmup_ckpt_name`).

Float32 master parameters; with ``dtype="bfloat16"`` the step runs under
``torch.autocast``. Dropout is on in train steps and off in eval steps. One
seeded ``torch.Generator`` on the device draws the train steps' dropout masks
and sched coins; each validation draws its coins once, from a generator
seeded by the step count, and every dev batch uses them (as the JAX package's
``step_rngs(key, 10_000_000 + step)`` gives every dev batch the same key).

On the card every train step, of either backbone, replays a CUDA graph of
the step (``train/graphs.py::GraphedStep``, the JAX package's jitted
``train_step``), the dropout and coin generators registered with it; the
first step runs eagerly and captures it. The loss it returns is the
graph's output, read by the logger before the next replay. Every dev batch
of a validation replays a graph of ``eval_step`` (its jitted ``eval_step``),
the validation's coins a static input. On the CPU the same loops run the
steps eagerly. The stage log's epoch line has the seconds of the epoch's
train steps (``train_s``) and of its validation (``val_s``).

Under the launcher (``parallel/``) each data rank trains on its rows of
every batch, the gradients averaged over the data group before the clip;
with more than one data rank the dropout masks come from a stream of the
rank and the coins from a stream alike on every rank
(``train/common.py::rank_generators``). Validation adds up every rank's
masked sums and counts; rank 0 saves and logs.
"""

from __future__ import annotations

import os
from functools import partial

import torch

from ..config import Config
from ..data.pipeline import make_batches
from ..data.prefetch import DevicePrefetcher
from ..models.generator import sched_coins
from ..ops.losses import softmax_cross_entropy_tokens
from ..parallel.mesh import barrier, is_main
from ..parallel.sharding import data_group, global_means, replicate, shard_batch
from ..utils.io import RunLogger
from ..utils.profiling import read_device_times, span
from .common import (autocast, build_generator, compute_dtype, get_corpus, get_device,
                     get_mesh, get_tokenizer, rank_generators)
from .graphs import step_runner
from .loop import EarlyStopper, Throughput, clock_of, validate
from .state import AdamWithClip, BestKeeper, save_state_dict

EVAL_SEED_OFFSET = 10_000_000
WARMUP_INPUTS = ("nx", "x", "labels")  # what a train step reads of a batch
EVAL_INPUTS = (*WARMUP_INPUTS, "row_mask")  # and an eval step, with the coins


def warmup_ckpt_name(cfg: Config) -> str:
    """The reference's name for the reference backbone, a backbone-qualified
    one otherwise, so another backbone never overwrites the LSTM's G (JAX
    ``train/warmup.py:30-34``)."""
    return "G.pth" if cfg.backbone == "lstm" else f"G_{cfg.backbone}.pth"


def make_warmup_steps(model, optimizer: AdamWithClip, dtype: torch.dtype = torch.float32):
    """(train_step, eval_step) of the denoising objective.

    ``train_step(batch, generator, coins=None, coin_generator=None)`` runs
    ``model`` in train mode (dropout and, unless ``coins`` is given, the
    sched coins from ``generator``, or drawn first from ``coin_generator``
    when there is one), back-propagates the token CE, takes one clipped Adam
    step and returns the loss from before the update. ``eval_step(batch, coins)``
    is the same decode in eval mode, without gradients, its CE over the rows
    of an optional ``row_mask``. ``batch`` holds tensors ``nx``, ``x``,
    ``labels`` on the model's device."""

    def loss(batch, generator, coins, row_mask=None):
        with autocast(batch["x"].device, dtype):
            logits = model(batch["nx"], batch["labels"], batch["x"], batch["labels"],
                           mode="sched", generator=generator, coins=coins)
            return softmax_cross_entropy_tokens(logits, batch["x"], row_mask=row_mask)

    def train_step(batch, generator=None, coins=None, coin_generator=None):
        if coins is None and coin_generator is not None:
            coins = sched_coins(batch["x"].shape[1], coin_generator, batch["x"].device)
        model.train()
        optimizer.zero_grad()
        value = loss(batch, generator, coins)
        value.backward()
        optimizer.step()
        return value.detach()

    @torch.no_grad()
    def eval_step(batch, coins):
        model.eval()
        return loss(batch, None, coins, batch.get("row_mask"))

    return train_step, eval_step


def run_warmup(cfg: Config, progress: bool = True) -> str:
    """Returns the path of the best generator checkpoint."""
    device = get_device(cfg)
    mesh = get_mesh(cfg, device)
    group, main = data_group(mesh), is_main()
    tokenizer = get_tokenizer(cfg)
    task_dump = os.path.join(cfg.ds_dump_dir, "warmup")
    os.makedirs(task_dump, exist_ok=True)
    g_path = os.path.join(task_dump, warmup_ckpt_name(cfg))

    bs = cfg.warmup_batch_size
    train_it = make_batches(get_corpus(cfg, "train", tokenizer), bs, cfg.max_len, "warmup",
                            shuffle=True, seed=cfg.seed)
    dev_it = make_batches(get_corpus(cfg, "dev", tokenizer), bs, cfg.max_len, "warmup",
                          shuffle=False, seed=cfg.seed)

    model = replicate(build_generator(cfg, len(tokenizer), device, training=True), mesh)
    optimizer = AdamWithClip(model.parameters(), cfg.warmup_lr, cfg.warmup_clip, group=group)
    train_step, eval_step = make_warmup_steps(model, optimizer, compute_dtype(cfg))
    generator, coin_generator = rank_generators(cfg.seed, device, mesh)
    run_step = step_runner(
        lambda inputs, _: train_step(inputs, generator, coin_generator=coin_generator),
        device, (generator, coin_generator), name="warmup.step")
    run_eval = step_runner(lambda inputs, _: [eval_step(inputs, inputs["coins"])], device,
                           name="warmup.eval_step")

    logger = RunLogger(f"{cfg.log_dir}/{cfg.dataset}", "warmup", config=cfg, enabled=main)
    stopper = EarlyStopper(cfg.warmup_patience)
    keeper = BestKeeper(write=main)
    thru = Throughput()

    step = 0
    for epoch in range(cfg.warmup_epochs):
        ep_steps = 0
        with span("epoch", step=epoch, always=True) as ep:
            for _, arrays in DevicePrefetcher(train_it, device,
                                              shard_fn=partial(shard_batch, mesh=mesh)):
                loss = run_step({k: arrays[k] for k in WARMUP_INPUTS})
                thru.add(bs)
                ep_steps += 1
                if step % 50 == 0:  # reads the loss: a sync every 50 steps
                    with span("log", step=step):
                        logger.log(step, **global_means({"dn_loss": loss}, group),
                                   **thru.rates())
                step += 1
            if device.type == "cuda":
                with span("train.sync", step=step):
                    torch.cuda.synchronize(device)
                read_device_times()

        # validation at epoch end, over the real rows (a rank's own rows);
        # every dev batch shares the validation's coins
        with span("validate", step=epoch, always=True) as val:
            eval_gen = torch.Generator(device).manual_seed(cfg.seed + EVAL_SEED_OFFSET + step)
            coins = sched_coins(cfg.max_len, eval_gen, device)
            val_loss = (validate(dev_it, run_eval, device, mesh, inputs=EVAL_INPUTS,
                                 static={"coins": coins}) or [0.0])[0]
        with span("log", step=step):
            logger.log(step, val_loss=val_loss, epoch=epoch, train_steps=ep_steps,
                       train_s=ep.seconds, val_s=val.seconds, **clock_of(device))
        if progress and main:
            print(f"[warmup] epoch {epoch} val_loss {val_loss:.4f} "
                  f"{thru.rates()['sentences_per_sec']:.1f} sent/s")
        with span("save", step=epoch):
            keeper.update(val_loss, model, g_path)
        if stopper.update(val_loss):
            break

    if main and keeper.last_path is None:  # no validation improvement recorded at all
        save_state_dict(model.state_dict(), g_path)
    logger.close()
    barrier()  # G is on disk before any rank goes on to read it
    return g_path
