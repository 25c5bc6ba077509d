"""Optimize stage: adversarial style-transfer fine-tuning of the generator, the
port of the JAX package's ``train/optimize.py`` (reference
``src/main_optimize.py``), train and test modes.

Train mode:
- loads the frozen pretrain scorers ``pretrain/{cls,mat,dn}.pth`` (all three
  required) and the warmup G (``G.pth``, or ``G_<backbone>.pth``) when
  there is one (``main_optimize.py:33-54``);
- two Adam(1e-5) optimizers behind clip 1.0: G applies every batch; D's
  gradients are summed into an accumulator over batches and applied, clip on
  the sum, at the epoch-local ``batch_idx % d_update_every == 0`` (so batch 0
  of each epoch at once); the accumulator is not reset between epochs
  (``main_optimize.py:78-88``);
- G step (``:96-113``): sample_p = G(x, src, None, 1-src, "st", tau);
  s = CE(cls(sample_p), 1-src), c = MSE(mat(sample_p, x), gap),
  adv = BCE(D(sample_p), 1) with D in eval mode while the frozen cls and
  mat run in train mode (dropout on), bk = CE(G(argmax(sample_p), 1-src,
  teacher=x, src), x); total = w_bt bk + w_c c + w_adv adv + w_s s, plus the
  optional ``w_rec`` reconstruction and style-weighted ``w_copy`` terms.
  Only G's parameters take its gradient; it flows through D and the scorers
  without reaching D's accumulator;
- then D (``:115-124``), against the updated G: a fresh no-grad st decode in
  train mode with D's own dropout stream (or, with ``fuse_gan_steps``, the G
  step's), real = D(x), fake = D(decode); w_adv * 0.5 (BCE(real, 1) +
  BCE(fake, 0)), D in train mode;
- validation (``:127-141``): tokens = argmax(st decode) in eval mode;
  CE(cls(tokens), 1-src) + CE(LM(tokens), tokens) + mean(mat(tokens, x))
  over the real rows, weighted by each batch's; the best G saved as
  ``G_epoch_<n>.pth`` with the previous best deleted, early stop at
  patience 3.

With ``time_major_probs`` (the default) the soft decode stacks stay (L, B,
V): the consumers project first, the back-translation input is the argmax
transposed, and the CE targets are transposed to match, so every loss equals
the batch-major one.

The training loop (JAX ``train/optimize.py:369-406`` with its
``megastep_k``, which scans k fused steps in one dispatch): k batches come
in one host-to-device copy (:class:`~..data.pipeline.MegaBatches`, its
short tail included; k=1 is one batch a copy), then k steps run back to
back, D applying at the epoch-local index ``% d_update_every``, and the
host synchronises once per k. On the card every step is a replay of a CUDA
graph of ``fused_step``, one graph per ``do_apply`` branch
(:class:`GraphedFusedStep`), whatever k is; a failed capture raises. On the
CPU the same loop runs ``fused_step`` eagerly. JAX's ``fused_step_dyn_fn``
(``:408-433``) traces ``do_apply`` so that XLA compiles both branches once;
eager PyTorch compiles nothing, and the graphs capture each branch once, so
it has no counterpart.

``resume`` (JAX ``:489-511, 575-583``): after every epoch the full state
(G and D, both optimizers with their step counts, the epoch, the step, the
best validation loss and its file, and the G and D random generators) goes
to ``optimize-<ver>/full_state/`` (:class:`~.checkpoint.
StateCheckpointer`); a resumed run restores it and goes on at the next
epoch, with the data order of that epoch. The D-gradient accumulator is not
saved and restarts at zero, as in the JAX package. Unlike the JAX package,
which restarts its step counter (and so its dropout and coin keys) at 0,
the generators go on where they stopped.

Test mode (``:157-174, 243-255``): the newest ``G_epoch_*``, else the warmup
G, transfers the train and test splits to ``.tsf`` files.

Under the launcher (``parallel/``) each data rank steps on its rows of every
batch (axis 1 of a group of k). G's gradient is averaged over the data group
in ``g_opt.step()``, before the clip; D's gradients are summed locally and
averaged once, at the apply (a sum of means is the mean of sums). On the
card the collectives are captured in the step's graphs. With more than one
data rank the dropout masks come from streams of the rank and the coins
from a stream alike on every rank (``train/common.py::rank_generators``).
Validation adds up every rank's masked sums and counts, so every rank takes
the same stop decision; rank 0 logs and writes the best G and the full
state, which holds every rank's generator states.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..config import Config
from ..data.pipeline import MegaBatches, make_batches
from ..data.prefetch import DevicePrefetcher
from ..models.generator import sched_coins
from ..ops.losses import (bce_with_logits, cross_entropy, masked_row_mean, mse,
                          softmax_cross_entropy_tokens, upcast)
from ..parallel.mesh import barrier, is_main, rank, world_size
from ..parallel.sharding import data_group, global_means, replicate, shard_stacked_batch
from ..utils.io import RunLogger
from ..utils.profiling import read_device_times, span
from .common import (autocast, build_classifier, build_discriminator, build_generator,
                     build_lm, build_matcher, compute_dtype, generator_call, get_corpus,
                     get_device, get_mesh, get_tokenizer, one_weight_cast, rank_generators)
from .checkpoint import StateCheckpointer
from .graphs import GraphedStep, step_runner
from .infer import run_inference
from .loop import EarlyStopper, Throughput, clock_of, validate
from .state import (AdamWithClip, AsyncSaver, BestKeeper, load_state_dict, newest_checkpoint,
                    params_exist)
from .warmup import warmup_ckpt_name

VAL_INPUTS = ("x", "labels", "row_mask")  # what val_step reads of a dev batch


class OptimizeModels:
    """The stage's five modules on one device: the generator (float32 master
    parameters), the three pretrain scorers and the discriminator."""

    def __init__(self, cfg: Config, n_vocab: int, device: torch.device):
        self.generator = build_generator(cfg, n_vocab, device, training=True)
        self.classifier = build_classifier(cfg, n_vocab, device)
        self.matcher = build_matcher(cfg, n_vocab, device)
        self.nt_checker = build_lm(cfg, n_vocab, device)
        self.disc = build_discriminator(cfg, n_vocab, device)


def load_frozen(cfg: Config, models: OptimizeModels) -> None:
    """Load the pretrain scorers with ``strict=True`` and freeze them
    (``requires_grad_(False)``); each is required, as in the reference."""
    pre = os.path.join(cfg.ds_dump_dir, "pretrain")
    for name, module in (("cls", models.classifier), ("mat", models.matcher),
                         ("dn", models.nt_checker)):
        path = os.path.join(pre, f"{name}.pth")
        if not params_exist(path):
            raise FileNotFoundError(f"{path}: the optimize stage needs the pretrain scorers")
        module.load_state_dict(load_state_dict(path), strict=True)
        module.requires_grad_(False)


def load_generator_params(cfg: Config, model) -> str | None:
    """Load the generator's weights into ``model`` with ``strict=True`` and
    return their path. Test mode (``main_optimize.py:47-54``): the newest
    ``optimize-<ver>/G_epoch_*.pth``, else the warmup G (``warmup/G.pth``,
    or ``G_<backbone>.pth``: ``warmup_ckpt_name``); raises when neither
    exists (test mode never decodes with fresh weights). Train mode
    (``:44-46``): the warmup G if it exists, else the fresh weights stay and
    None is returned."""
    warm = os.path.join(cfg.ds_dump_dir, "warmup", warmup_ckpt_name(cfg))
    if cfg.mode == "test":
        path = newest_checkpoint(os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}")) or warm
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no generator checkpoint: neither {cfg.ds_dump_dir}/optimize-{cfg.ver}/"
                f"G_epoch_*.pth nor {path}")
    elif params_exist(warm):
        path = warm
    else:
        return None
    model.load_state_dict(load_state_dict(path), strict=True)
    return path


class OptimizeSteps(NamedTuple):
    """The stage's step functions. ``fused_step`` is the per-batch entry of
    the training loop; the pieces are there for tests and ablations."""

    g_loss_fn: Callable
    d_loss_fn: Callable
    g_step: Callable
    d_grads: Callable
    d_grads_reuse: Callable
    d_apply: Callable
    accumulate: Callable
    val_step: Callable
    fused_step: Callable


def make_optimize_steps(cfg: Config, models: OptimizeModels, g_opt: AdamWithClip,
                        d_opt: AdamWithClip, copy_weights=None, group=None) -> OptimizeSteps:
    """Steps over ``models`` that update G through ``g_opt`` and D through
    ``d_opt``. ``copy_weights``: optional (V,) style-neutrality weights
    (``data/style_weights.py``) of the ``w_copy`` term; None = uniform.
    ``group``: the data group of a data-parallel run, over which the
    weighted ``w_copy`` term, a ratio of sums, takes its denominator.

    A ``batch`` is a dict of tensors on the models' device (``x``,
    ``labels``, and for validation an optional ``row_mask``). Randomness
    comes from explicit generators: ``generator`` (G's dropout, the frozen
    scorers' and the sched coins, unless a ``coin_generator`` draws those)
    and ``d_generator`` (D's dropout and the fresh fake decode's). ``coins``
    ((L,) bool) replaces the sched coins of the back-translation and
    reconstruction decodes, which share one draw a step, as in the JAX
    package."""
    G, CLS, MAT, NT, D = (models.generator, models.classifier, models.matcher,
                          models.nt_checker, models.disc)
    g_params, d_params = list(G.parameters()), list(D.parameters())
    dtype = compute_dtype(cfg)
    # an LSTM layout: the other backbones decode batch-major, where the flag
    # would only move the transpose (JAX optimize.py:175)
    tm = cfg.time_major_probs and cfg.backbone == "lstm"
    # the other backbones' teacher-forced decodes draw no sched coins
    draw_coins = cfg.backbone == "lstm"
    ranks = 1 if group is None else dist.get_world_size(group)
    if copy_weights is not None:
        copy_weights = torch.as_tensor(copy_weights, device=g_params[0].device).to(
            torch.promote_types(g_params[0].dtype, torch.float32))

    def st_decode(batch, generator, time_major: bool):
        return generator_call(G, batch["x"], batch["labels"], None, 1 - batch["labels"],
                              mode="st", tau=cfg.tau, time_major_out=time_major,
                              generator=generator)

    def g_loss_fn(batch, generator=None, coins=None, copy_scale: float = 1.0,
                  coin_generator=None):
        """(total, aux, sample_p) with the graph of the loss, G and the frozen
        cls and mat in train mode, D in eval mode. sample_p is (L, B, V) with
        ``time_major_probs``, else (B, L, V); every consumer follows it."""
        for m in (G, CLS, MAT):
            m.train()
        D.eval()
        x, labels = batch["x"], batch["labels"]
        if coins is None and draw_coins:
            coins = sched_coins(x.shape[1], coin_generator or generator, x.device)
        # G's decode and back-translation pass share one cast of its weights
        with autocast(x.device, dtype), one_weight_cast(G):
            sample_p = st_decode(batch, generator, tm)
            s_logits = CLS(sample_p, generator, time_major=tm)
            c_logits = MAT(sample_p, x, generator, time_major=tm)
            adv_logits = D(sample_p, time_major=tm)
            bk_inp = sample_p.detach().argmax(dim=-1)
            if tm:
                bk_inp = bk_inp.t()  # (L, B) -> (B, L) ids
            bk_logits = generator_call(G, bk_inp, 1 - labels, x, labels, mode="sched",
                                       time_major_out=tm, generator=generator, coins=coins)
            # CE over B*L is transpose-invariant: time-major logits take
            # time-major targets
            tgt = x.t() if tm else x
            s_loss = cross_entropy(s_logits, 1 - labels)
            c_loss = mse(c_logits, torch.full_like(c_logits, cfg.gap))
            adv_loss = bce_with_logits(adv_logits, torch.ones_like(adv_logits))
            bk_loss = softmax_cross_entropy_tokens(bk_logits, tgt)
            total = cfg.w_bt * bk_loss + cfg.w_c * c_loss + cfg.w_adv * adv_loss + cfg.w_s * s_loss
            aux = {"G": adv_loss, "STI": s_loss, "CP": c_logits.float().mean(), "BK": bk_loss}
            if cfg.w_rec > 0:
                # same-style teacher-forced reconstruction: anchors G to its
                # input content (no reference equivalent)
                rec_logits = generator_call(G, x, labels, x, labels, mode="sched",
                                            time_major_out=tm, generator=generator, coins=coins)
                rec_loss = softmax_cross_entropy_tokens(rec_logits, tgt)
                total = total + cfg.w_rec * rec_loss
                aux["REC"] = rec_loss
            if cfg.w_copy > 0:
                # NLL of the source tokens under the free-running transfer
                # probs, each position weighted by its token's neutrality
                # when copy_weights is given; the grid follows the layout
                t_ax = 0 if tm else 1
                n = min(sample_p.shape[t_ax], x.shape[1])
                src = (x[:, :n].t() if tm else x[:, :n]).long()
                probs = sample_p[:n] if tm else sample_p[:, :n]
                nll = -torch.log(upcast(probs.gather(-1, src[..., None])[..., 0]) + 1e-9)
                if copy_weights is None:
                    copy_loss = nll.mean()
                else:
                    w = copy_weights[src]
                    den = w.sum()
                    if group is not None:
                        # a ratio of global sums: this rank's numerator over
                        # the group's denominator / D, so the mean over the
                        # ranks (the gradient's all-reduce) is the global one
                        dist.all_reduce(den, group=group)
                    copy_loss = (w * nll).sum() / (torch.clamp_min(den, 1e-6) / ranks)
                total = total + cfg.w_copy * copy_scale * copy_loss
                aux["COPY"] = copy_loss
        aux["loss"] = total
        return total, aux, sample_p

    def g_step(batch, generator=None, coins=None, copy_scale: float = 1.0, coin_generator=None):
        """One G update; returns (aux, the decode sample_p without its graph)."""
        total, aux, sample_p = g_loss_fn(batch, generator, coins, copy_scale, coin_generator)
        g_opt.zero_grad()
        total.backward(inputs=g_params)  # G's gradients only: D's .grad stays as it is
        g_opt.step()
        return {k: v.detach() for k, v in aux.items()}, sample_p.detach()

    def d_loss_fn(fake_p, batch, d_generator=None):
        """D's loss in train mode; fake_p carries the G step's layout, the
        real side is batch-major ids."""
        D.train()
        with autocast(batch["x"].device, dtype):
            t_logits = D(batch["x"], d_generator)
            f_logits = D(fake_p, d_generator, time_major=tm)
            loss = 0.5 * (bce_with_logits(t_logits, torch.ones_like(t_logits))
                          + bce_with_logits(f_logits, torch.zeros_like(f_logits)))
        return cfg.w_adv * loss

    def d_grads_reuse(fake_p, batch, d_generator=None):
        """(D's gradients, loss) on a given fake decode (``fuse_gan_steps``)."""
        loss = d_loss_fn(fake_p, batch, d_generator)
        return list(torch.autograd.grad(loss, d_params)), loss.detach()

    def d_grads(batch, d_generator=None):
        """(D's gradients, loss) on a fresh fake decode of the current G, in
        train mode under no_grad (``main_optimize.py:118-119``)."""
        G.train()
        with torch.no_grad(), autocast(batch["x"].device, dtype), one_weight_cast(G):
            fake_p = st_decode(batch, d_generator, tm)
        return d_grads_reuse(fake_p, batch, d_generator)

    @torch.no_grad()
    def accumulate(acc: list, grads: list) -> list:
        torch._foreach_add_(acc, grads)
        return acc

    @torch.no_grad()
    def d_apply(acc: list) -> None:
        """One D update on the accumulated gradients (the clip acts on the
        sum); D's Adam step count moves only here."""
        for p, a in zip(d_params, acc):
            p.grad.copy_(a)
        d_opt.step()

    @torch.no_grad()
    def val_step(batch):
        for m in (G, CLS, MAT, NT):
            m.eval()
        rows = batch.get("row_mask")
        x, labels = batch["x"], batch["labels"]
        with autocast(x.device, dtype):
            with one_weight_cast(G):
                tokens = st_decode(batch, None, False).argmax(dim=-1)
            s_loss = cross_entropy(CLS(tokens), 1 - labels, mask=rows)
            nt_loss = softmax_cross_entropy_tokens(NT(tokens), tokens, row_mask=rows)
            c_logits = MAT(tokens, x)
            c_mean = c_logits.float().mean() if rows is None else masked_row_mean(c_logits, rows)
        return nt_loss + s_loss + c_mean

    def fused_step(batch, acc: list, do_apply: bool, generator=None, d_generator=None,
                   copy_scale: float = 1.0, coins=None, coin_generator=None):
        """One training batch in the reference's order: the G update, then
        D's gradients against the updated G (a fresh decode, or the G step's
        with ``fuse_gan_steps``) summed into ``acc``, then, when
        ``do_apply``, the D update and ``acc`` reset to zero. Returns (aux,
        d_loss)."""
        aux, sample_p = g_step(batch, generator, coins, copy_scale, coin_generator)
        if cfg.fuse_gan_steps:
            grads, d_loss = d_grads_reuse(sample_p, batch, d_generator)
        else:
            grads, d_loss = d_grads(batch, d_generator)
        accumulate(acc, grads)
        if do_apply:
            d_apply(acc)
            torch._foreach_zero_(acc)
        return aux, d_loss

    return OptimizeSteps(g_loss_fn, d_loss_fn, g_step, d_grads, d_grads_reuse, d_apply,
                         accumulate, val_step, fused_step)


class GraphedFusedStep(GraphedStep):
    """``fused_step`` as CUDA graphs, one per ``do_apply`` branch
    (:class:`~.graphs.GraphedStep`): each call copies the batch's ``x`` and
    ``labels`` (and, with ``given_coins``, the (L,) sched coins) into the
    branch's static buffers and replays its graph; the first call of a
    branch runs the step eagerly on a side stream and then captures it.

    The G and D generators (and a coin generator, when there is one) are
    registered with each graph. The collectives of a data-parallel step (the
    optimizers' all-reduces) are captured too: the process group exists
    before, and the eager first call of a branch runs them on the side
    stream, which sets up the communicator before the capture.
    ``copy_scale`` is a 0-dim tensor on the card that the caller fills (each
    epoch), not a constant baked into the capture. A call returns the graph's
    static outputs ``(aux, d_loss)``, which the next replay of that branch
    overwrites: copy what must outlive it. The two branches' graphs share
    one memory pool (``GraphedStep``'s ``share_pool``): the next call of
    either branch may overwrite a call's outputs."""

    NAME = "optimize.fused_step"  # its branches' name in the recorder's graphs

    def __init__(self, fused_step: Callable, acc: list, generator: torch.Generator,
                 d_generator: torch.Generator, copy_scale: torch.Tensor,
                 given_coins: bool = False, coin_generator: torch.Generator | None = None):
        def run(static: dict, do_apply: bool):
            return fused_step(static, acc, do_apply, generator, d_generator,
                              copy_scale=copy_scale, coins=static.get("coins"),
                              coin_generator=coin_generator)

        super().__init__(run, (generator, d_generator, coin_generator), name=self.NAME,
                         share_pool=True)
        self.given_coins = given_coins

    def __call__(self, batch: dict, do_apply: bool, coins: torch.Tensor | None = None):
        inputs = {"x": batch["x"], "labels": batch["labels"]}
        if self.given_coins:
            inputs["coins"] = coins
        return super().__call__(inputs, do_apply)


def run_optimize(cfg: Config, progress: bool = True) -> str | None:
    """Train mode; returns the path of the best G checkpoint (None if the
    validation loss never improved: the reference keeps none then either)."""
    if cfg.megastep_k < 1:
        raise ValueError(f"megastep_k must be at least 1, got {cfg.megastep_k}")
    device = get_device(cfg)
    mesh = get_mesh(cfg, device)
    group, main = data_group(mesh), is_main()
    tokenizer = get_tokenizer(cfg)
    V = len(tokenizer)
    models = OptimizeModels(cfg, V, device)
    load_frozen(cfg, models)
    load_generator_params(cfg, models.generator)
    for m in (models.generator, models.classifier, models.matcher, models.nt_checker, models.disc):
        replicate(m, mesh)
    g_opt = AdamWithClip(models.generator.parameters(), cfg.optimize_lr, cfg.optimize_clip,
                         group=group)
    d_opt = AdamWithClip(models.disc.parameters(), cfg.optimize_lr, cfg.optimize_clip,
                         group=group)

    task_dump = os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}")
    os.makedirs(task_dump, exist_ok=True)
    train_corpus = get_corpus(cfg, "train", tokenizer)
    train_it = make_batches(train_corpus, cfg.batch_size, cfg.max_len, "optimize",
                            shuffle=True, seed=cfg.seed)
    dev_it = make_batches(get_corpus(cfg, "dev", tokenizer), cfg.batch_size, cfg.max_len,
                          "optimize", shuffle=False, seed=cfg.seed)
    copy_weights = None
    if cfg.w_copy > 0 and cfg.copy_mask:
        from ..data.style_weights import style_neutrality_weights

        copy_weights = style_neutrality_weights(train_corpus, V)
    steps = make_optimize_steps(cfg, models, g_opt, d_opt, copy_weights=copy_weights,
                                group=group)

    logger = RunLogger(f"{cfg.log_dir}/{cfg.dataset}", "optimize", cfg.ver, config=cfg,
                       enabled=main)
    stopper = EarlyStopper(cfg.optimize_patience)
    # best-G save + previous-best delete on a worker thread, overlapped with
    # the next epoch (the reference's torch.save sits on the critical path)
    saver = AsyncSaver()
    keeper = BestKeeper(saver=saver, write=main)
    thru = Throughput()
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    generator, coin_generator = rank_generators(cfg.seed, device, mesh)
    d_generator, _ = rank_generators(cfg.seed + 1, device, mesh)

    start_epoch, step = 0, 0
    ckpt = StateCheckpointer(os.path.join(task_dump, "full_state")) if cfg.resume else None
    state = ckpt.restore() if ckpt is not None else None
    if state is not None:
        models.generator.load_state_dict(state["g"], strict=True)
        models.disc.load_state_dict(state["d"], strict=True)
        g_opt.load_state_dict(state["g_opt"])
        d_opt.load_state_dict(state["d_opt"])
        restore_streams(state, generator, d_generator, coin_generator)
        keeper.best = stopper.best = state["best"]
        keeper.last_path = state["best_path"]
        start_epoch, step = state["epoch"] + 1, state["step"]
        train_it.epoch = start_epoch  # that epoch's batch order

    # the epoch's copy_scale lives on the device, so the graphs read it
    copy_scale = torch.ones((), device=device)
    if device.type == "cuda":
        run_step = GraphedFusedStep(steps.fused_step, acc, generator, d_generator, copy_scale,
                                    coin_generator=coin_generator)
    else:
        def run_step(batch, do_apply):
            return steps.fused_step(batch, acc, do_apply, generator, d_generator, copy_scale,
                                    coin_generator=coin_generator)

    run_val = step_runner(lambda inputs, _: [steps.val_step(inputs)], device,
                          name="optimize.val_step")

    for epoch in range(start_epoch, cfg.epochs):
        copy_scale.fill_(cfg.w_copy_decay ** epoch)  # 1.0 unless a decay is configured
        ep_steps, d_applies = 0, 0
        with span("epoch", step=epoch, always=True) as ep:
            for _, stacked in DevicePrefetcher(MegaBatches(train_it, cfg.megastep_k), device,
                                               shard_fn=partial(shard_stacked_batch, mesh=mesh)):
                logs = []
                for i in range(stacked["x"].shape[0]):
                    do_apply = ep_steps % cfg.d_update_every == 0  # epoch-local index
                    aux, d_loss = run_step({k: v[i] for k, v in stacked.items()}, do_apply)
                    d_applies += do_apply
                    thru.add(cfg.batch_size)
                    ep_steps += 1
                    if step % 20 == 0:  # copied out before a replay overwrites them
                        logs.append((step, {"D": d_loss.clone(),
                                            **{k: v.clone() for k, v in aux.items()}}))
                    step += 1
                if device.type == "cuda":
                    with span("train.sync", step=step):
                        torch.cuda.synchronize(device)  # once per group of k batches
                    read_device_times()
                for logged_step, metrics in logs:
                    with span("log", step=logged_step):
                        logger.log(logged_step, **global_means(metrics, group), **thru.rates())

        # validation over the real rows (a rank's own rows)
        with span("validate", step=epoch, always=True) as val:
            val_loss = (validate(dev_it, run_val, device, mesh, inputs=VAL_INPUTS) or [0.0])[0]
        with span("log", step=step):
            logger.log(step, val_loss=val_loss, epoch=epoch, train_steps=ep_steps,
                       train_s=ep.seconds, val_s=val.seconds, d_applies=d_applies,
                       epoch_sent_per_s=ep_steps * cfg.batch_size
                       / max(ep.seconds + val.seconds, 1e-6), **clock_of(device))
        if progress and main:
            print(f"[optimize] epoch {epoch} val_loss {val_loss:.4f} "
                  f"{thru.rates()['sentences_per_sec']:.1f} sent/s")
        with span("save", step=epoch):
            keeper.update(val_loss, models.generator,
                          os.path.join(task_dump, f"G_epoch_{epoch}.pth"), delete_previous=True)
            if ckpt is not None:
                saver.wait()  # the best G it names is on disk first
                payload = {
                    "g": models.generator.state_dict(), "d": models.disc.state_dict(),
                    "g_opt": g_opt.state_dict(), "d_opt": d_opt.state_dict(),
                    "generator": generator.get_state(), "d_generator": d_generator.get_state(),
                    "epoch": epoch, "step": step, "best": keeper.best,
                    "best_path": keeper.last_path,
                }
                streams = gather_streams((generator, d_generator, coin_generator))
                if streams is not None:  # every rank's streams, for rank 0 to save
                    payload["rank_generators"] = streams
                if main:
                    ckpt.save(epoch, payload)
                barrier()
        if stopper.update(val_loss):
            break

    with span("save"):
        saver.close()  # drain the pending best-G writes, re-raising worker errors
    logger.close()
    barrier()  # the best G is on disk before any rank goes on to read it
    return keeper.last_path


def gather_streams(generators) -> list | None:
    """Every rank's states of ``generators`` (a None stays None), gathered
    on every rank in rank order (``all_gather_object``); None in one
    process."""
    if world_size() == 1:
        return None
    streams = [None] * world_size()
    dist.all_gather_object(streams, [None if g is None else g.get_state() for g in generators])
    return streams


def restore_streams(state: dict, generator, d_generator, coin_generator) -> None:
    """Set this rank's G, D and coin generators from a full state: the
    single states of a one-process run, or this rank's entry of
    ``rank_generators``, which a state saved under the launcher holds. The
    world size must be the one the state was saved with."""
    streams = state.get("rank_generators")
    if streams is None and world_size() == 1:
        generator.set_state(state["generator"])
        d_generator.set_state(state["d_generator"])
        return
    if streams is None or len(streams) != world_size():
        raise ValueError(f"the full state was saved by {len(streams or [None])} rank(s); "
                         f"resume it with that world size, not {world_size()}")
    for gen, st in zip((generator, d_generator, coin_generator), streams[rank()]):
        if (gen is None) != (st is None):
            raise ValueError("the full state's coin stream does not fit this mesh")
        if gen is not None:
            gen.set_state(st)


def run_test(cfg: Config) -> list[str]:
    """Test mode: transfer the train and test splits to .tsf files."""
    device = get_device(cfg)
    mesh = get_mesh(cfg, device)
    tokenizer = get_tokenizer(cfg)
    model = build_generator(cfg, len(tokenizer), device)
    load_generator_params(cfg, model)
    return run_inference(cfg, replicate(model, mesh), tokenizer, mesh=mesh)
