"""The full optimize-stage GAN step on an explicit ``(data, model)`` mesh: the
port of the JAX package's ``parallel/exercise.py`` (its multi-chip gate).

:func:`optimize_step_on_mesh` runs ``fused_step`` (the straight-through
decode, the back-translation, the frozen scorers, D's gradients and their
accumulation) with each data rank on its rows of the batch and, over the
``model`` dimension, the tensor-parallel rules of
``parallel/sharding.py::TP_RULES`` on G, D and the frozen towers, then a
validation step; optionally a full-state save, a restore and one more step.
It runs in the processes the caller starts, one per rank of an
``n_data * n_model`` process group (``torch.distributed``, gloo on the CPU);
``(1, 1)`` runs in one process without a group.

The scorers are 2 layers, 4 heads, d=128 by default, as in the JAX exercise:
the same rules apply, at a size that runs in seconds. Under TP the modules
compute with DTensor parameters inside ``implicit_replication``: the
batch's plain tensors count as replicated over ``model``, and DTensor
inserts the model-group collectives. The decode runs in ``st`` mode
through the unfused head, so the decode-head kernel is not on this path, as
in the JAX exercise. The sched coins are given, drawn from one seeded CPU
generator, so every mesh shape draws the same ones; with ``p_drop=0`` no
dropout is drawn either and the losses of every shape agree.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace


def optimize_step_on_mesh(n_data: int, n_model: int, *, vocab: int = 256, max_len: int = 6,
                          batch: int | None = None, n_steps: int = 1,
                          ckpt_dir: str | None = None, small_scorers: bool = True,
                          dtype: str | None = None, p_drop: float | None = None, clip: float = 1.0,
                          device: str = "cuda", verbose: bool = False) -> dict:
    """Run ``n_steps`` fused GAN steps and a validation step; return scalars.

    D applies at ``step % d_update_every == 0`` (0, 4, 8, ...), and after
    each apply the accumulator must be zero. With ``ckpt_dir`` the full state
    (G and D, both Adams; the whole tensors of every DTensor) is saved by
    rank 0, restored by every rank, checked against the live parameters,
    laid out on the mesh again, and trained one more step. The losses are
    means over the global batch (averaged over the data group). Raises on
    any failure; returns finite floats otherwise. It runs on ``device``, the
    card unless the caller asks for the CPU (``device="cpu"``, gloo), and
    raises when CUDA is asked for and absent (``train/common.py::get_device``).

    Both optimizers clip the global norm at ``clip`` (1.0, as in the JAX
    exercise). ``moments`` holds, for every parameter of G and D, the norms of the
    whole gradient as the last step left it (averaged over the data group,
    clipped) and of Adam's two moments: the numbers a wrong global norm or
    a sharded gradient off by a factor would change, where the losses after
    a few small Adam steps would not."""
    t0 = time.perf_counter()

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config import make_config
    from ..models import DenoiseSeq2Seq, PairMatcher, RelGANDiscriminator, TextCNN, TransformerLM
    from ..models.generator import sched_coins
    from ..train.checkpoint import StateCheckpointer
    from ..train.common import COIN_SEED_OFFSET, _scorer_size_kw, get_device, rank_generators
    from ..train.optimize import OptimizeModels, make_optimize_steps
    from ..train.state import AdamWithClip
    from .mesh import barrier, is_main, make_mesh
    from .sharding import (all_reduce_mean, data_group, full_tensor, shard_batch,
                           shard_params)

    def say(msg):
        if verbose and is_main():
            print(f"[exercise +{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    V, L = vocab, max_len
    B = batch if batch is not None else 2 * n_data * n_model
    cfg = make_config("yelp", max_len=L, vocab_size=V, device=device)
    dev = get_device(cfg)
    cfg.mesh.n_data, cfg.mesh.n_model = n_data, n_model
    if small_scorers:
        cfg.scorer_layers, cfg.scorer_d_model, cfg.scorer_heads = 2, 128, 4
    if dtype is not None:
        cfg.dtype = dtype
    mesh = make_mesh(n_data, n_model, dev.type)
    group = data_group(mesh)
    tp = n_model > 1

    if p_drop is None:
        models = OptimizeModels(cfg, V, dev)
    else:  # every module at this rate (OptimizeModels keeps the scorers' 0.1), build_*'s seeds
        size = _scorer_size_kw(cfg)
        models = SimpleNamespace(
            generator=DenoiseSeq2Seq(V, cfg.n_class, L, p_drop=p_drop, seed=cfg.seed).train(),
            classifier=TextCNN(V, cfg.n_class, p_drop=p_drop, seed=cfg.seed),
            matcher=PairMatcher(V, p_drop=p_drop, seed=cfg.seed + 1, **size),
            nt_checker=TransformerLM(V, p_drop=p_drop, seed=cfg.seed + 2, **size),
            disc=RelGANDiscriminator(V, p_drop=p_drop, seed=cfg.seed + 99))
    modules = {name: getattr(models, name).to(dev) for name in
               ("generator", "classifier", "matcher", "nt_checker", "disc")}
    for name in ("classifier", "matcher", "nt_checker"):
        modules[name].requires_grad_(False)
    if tp:
        for m in modules.values():
            shard_params(m, mesh)
    say(f"models built on mesh {n_data}x{n_model}")

    g_opt = AdamWithClip(models.generator.parameters(), 1e-5, clip, group=group)
    d_opt = AdamWithClip(models.disc.parameters(), 1e-5, clip, group=group)
    steps = make_optimize_steps(cfg, models, g_opt, d_opt, group=group)
    every = cfg.d_update_every
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    generator, _ = rank_generators(cfg.seed, dev, mesh)
    d_generator, _ = rank_generators(cfg.seed + 1, dev, mesh)
    coin_gen = torch.Generator().manual_seed(cfg.seed + COIN_SEED_OFFSET)

    data = shard_batch({
        "x": torch.from_numpy(np.random.RandomState(0).randint(0, V, (B, L))),
        "labels": torch.from_numpy(np.random.RandomState(1).randint(0, 2, (B,))),
    }, mesh)
    data = {k: v.to(dev) for k, v in data.items()}

    def global_mean(t) -> float:
        t = full_tensor(t).detach().float().reshape(1).clone()
        all_reduce_mean([t], group)
        return float(t)

    if tp:
        from torch.distributed.tensor.experimental import implicit_replication as replicated
    else:
        replicated = contextlib.nullcontext

    def step_once(step):
        do_apply = step % every == 0
        coins = sched_coins(L, coin_gen, "cpu").to(dev)
        with replicated():
            aux, d_loss = steps.fused_step(data, acc, do_apply, generator, d_generator,
                                           coins=coins)
        out = (global_mean(aux["loss"]), global_mean(d_loss))
        if do_apply:  # the apply must have zeroed the accumulator
            acc_max = max(float(full_tensor(a).abs().max()) for a in acc)
            assert acc_max == 0.0, f"accumulator not reset at step {step}"
        say(f"step {step} done (apply={do_apply}) G={out[0]:.4f} D={out[1]:.4f}")
        return out

    losses = [step_once(step) for step in range(n_steps)]
    assert all(np.isfinite(g) and np.isfinite(d) for g, d in losses), losses

    if ckpt_dir is not None:
        def whole(obj):
            if isinstance(obj, dict):
                return {k: whole(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(whole(v) for v in obj)
            return full_tensor(obj) if isinstance(obj, torch.Tensor) else obj

        payload = whole({"g": models.generator.state_dict(), "d": models.disc.state_dict(),
                         "g_opt": g_opt.state_dict(), "d_opt": d_opt.state_dict()})
        ckpt = StateCheckpointer(ckpt_dir)
        if is_main():
            ckpt.save(n_steps, payload)
        barrier()
        restored = ckpt.restore()
        say("save + restore done")
        for key, module, opt in (("g", models.generator, g_opt), ("d", models.disc, d_opt)):
            with torch.no_grad():
                for name, p in module.named_parameters():
                    want = restored[key][name].to(dev)
                    torch.testing.assert_close(full_tensor(p), want, rtol=0, atol=0)
                    p.copy_(_like(want, p))
            params = list(module.parameters())
            state = restored[f"{key}_opt"]
            for i, st in state["state"].items():
                for k, v in st.items():
                    if k != "step":
                        st[k] = _like(v.to(dev), params[i])
            opt.load_state_dict(state)
        losses.append(step_once(n_steps))
        say("post-restore continuation step done")

    with replicated():
        val = steps.val_step(data)
    say("val step done")
    return {
        "mesh": {"data": n_data, "model": n_model},
        "g_loss": losses[-1][0],
        "d_loss": losses[-1][1],
        "val": global_mean(val),
        "n_steps": len(losses),
        "ckpt_roundtrip": ckpt_dir is not None,
        "wall_s": time.perf_counter() - t0,
        "losses": losses,
        "moments": _moments({"g": g_opt, "d": d_opt}),
        "placements": {name: [str(pl) for pl in getattr(p, "placements", ())]
                       for mod in modules.values() for name, p in mod.named_parameters()
                       if getattr(p, "placements", None)} if tp else {},
        "dist": dist.is_initialized(),
    }


def _moments(opts: dict) -> dict:
    """``{"<opt>/<i>/<kind>": norm}``: the norms of the whole gradient
    (``grad``) and Adam moments (``exp_avg``, ``exp_avg_sq``) of parameter
    ``i`` of each optimizer."""
    import torch

    from .sharding import full_tensor

    out = {}
    for key, opt in opts.items():
        for i, p in enumerate(opt.params):
            state = opt.adam.state[p]
            for kind, t in (("grad", p.grad), ("exp_avg", state["exp_avg"]),
                            ("exp_avg_sq", state["exp_avg_sq"])):
                out[f"{key}/{i}/{kind}"] = float(torch.linalg.vector_norm(full_tensor(t)))
    return out


def _like(full, param):
    """``full`` laid out as ``param``: a DTensor of its mesh and placements
    when ``param`` is one, else ``full``."""
    if hasattr(param, "placements"):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full, param.device_mesh, list(param.placements))
    return full
