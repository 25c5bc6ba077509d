"""Command line of the port:

    python -m consistent__style_transfer_torch <command> [--flags]

Commands:
  vocab         train/load the BPE tokenizer dump
  w2v           train/load the WMD word2vec dump
  pretrain      stage 1: the three scorers (classifier, matcher, LM denoiser)
  warmup        stage 2: the generator's denoising warmup -> warmup/G.pth
                (warmup/G_<backbone>.pth with --backbone transformer or lfm2_moe)
  optimize      stage 3: adversarial style transfer -> optimize-<ver>/G_epoch_<n>.pth
                (--mode=test: inference, as infer)
  serve         stdin->stdout batch transfer with the current best G
  infer         transfer train+test splits to .tsf with the current best G
                (optimize --mode=test)
  eval-prepare  train the eval models (idempotent): the style classifier
                (on the device), the lexicon, the masked word2vec and the
                version's adversarial LR
  eval          print STI / CP / NT, ACC, self-BLEU and ref-BLEU
  run           full pipeline: optimize train -> test -> eval-prepare -> eval,
                the results also written to <out_dir>/<ds>-<ver>.txt (the
                reference's run.sh; assumes the pretrain and warmup dumps)
  ablate        the reference's job.sh sweep: warmup once, then optimize
                train + test, eval-prepare and eval for each ver in {full,
                wo_s, wo_c, wo_adv, wo_bt, wo_allc}

Two flags choose the generator and its decode: ``--backbone
lstm|transformer|lfm2_moe`` (every command that trains or runs G: the
reference's LSTM, the T5-small-wide transformer, which computes in float32
whatever ``--dtype`` says, or LFM2-8B-A1B at its published widths, a
conv/GQA hybrid with 32 experts, top 4, which follows ``--dtype`` (on the
card bfloat16 alone);
``--lfm2_layers N`` holds the first N of its 24 layers) and
``--beam_size K`` (``serve``, ``infer`` and the test half of
``run``/``ablate`` decode with a length-normalised beam of K, any
backbone, instead of greedy).

Data parallelism: one process per GPU under the PyTorch launcher,

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m consistent__style_transfer_torch <command> ... [--n_data D --n_model M]

NCCL on the card (rank r on cuda:LOCAL_RANK), gloo with ``--device cpu``.
``D * M`` must be N (``--n_data`` defaults to N // M); a model axis in a
CLI run only repeats the work, the parameters being replicated. Each data
rank takes its rows of every batch (``pretrain``, ``warmup``, ``optimize``,
``infer``, and the training and decoding of ``run`` and ``ablate``); rank 0
writes every file and runs the eval commands while the others wait.
``serve`` runs in one process. Without the launcher every command runs in
one process, and a mesh other than 1 x 1 raises.

The JAX package's ``bench`` is not ported yet and exits with status 2;
ROADMAP.md has the order. Every command runs on ``--device cuda`` (the
default) unless given ``--device cpu``; without CUDA it raises. With
``TPUST_TRACE=1`` a command runs under ``torch.profiler`` and writes a
Chrome trace to ``$TPUST_TRACE_DIR`` (default ``log/trace``); with
``TPUST_KERNEL_COUNTS=1`` it prints its seconds and the port's kernel
launch counts as one JSON line to stderr, on each rank.
"""

from __future__ import annotations

import sys

from .config import Config, config_from_args
from .parallel.mesh import barrier, destroy_distributed, init_distributed, is_main, world_size

NOT_PORTED = ("bench",)


def _eval_dir(cfg: Config) -> str:
    return f"{cfg.out_dir}/../evaluate_runtime"


def say(*args) -> None:
    """print on rank 0 only (every process without the launcher)."""
    if is_main():
        print(*args)


def cmd_vocab(cfg: Config) -> None:
    from .train.common import get_tokenizer

    tok = get_tokenizer(cfg)
    say(f"vocab size: {len(tok)} -> {cfg.vocab_paths[0]}")


def cmd_w2v(cfg: Config) -> None:
    from .train.common import get_tokenizer, get_w2v

    w2v = get_w2v(cfg, get_tokenizer(cfg))
    say(f"w2v vocab: {len(w2v.vocab)} -> {cfg.w2v_path}")


def cmd_pretrain(cfg: Config) -> None:
    from .train.pretrain import run_pretrain

    say("pretrain artifacts:", run_pretrain(cfg))


def cmd_warmup(cfg: Config) -> None:
    from .train.warmup import run_warmup

    say("warmup G:", run_warmup(cfg))


def cmd_optimize(cfg: Config) -> None:
    from .train.optimize import run_optimize, run_test

    if cfg.mode == "test":
        say("wrote:", run_test(cfg))
    else:
        say("best G:", run_optimize(cfg))


def cmd_infer(cfg: Config) -> None:
    cfg.mode = "test"
    cmd_optimize(cfg)


def _on_main(fn, cfg: Config) -> None:
    """Run ``fn(cfg)`` on rank 0 while the other ranks wait: the eval
    commands are host-bound and work file by file."""
    try:
        if is_main():
            fn(cfg)
    finally:
        barrier()


def _eval_prepare(cfg: Config) -> None:
    from .evaluate.prepare import run_prepare
    from .train.common import get_device

    run_prepare(cfg.ds_data_dir, cfg.run_out_dir, _eval_dir(cfg), cfg.dataset,
                ver=cfg.ver, seed=cfg.seed, device=get_device(cfg))


def _eval(cfg: Config) -> None:
    from .evaluate.run_eval import run_eval
    from .train.common import get_device

    get_device(cfg)  # the scoring runs on the host; the command checks its device as all do
    run_eval(cfg.ds_data_dir, cfg.run_out_dir, _eval_dir(cfg), cfg.dataset, cfg.ver)


def cmd_eval_prepare(cfg: Config) -> None:
    _on_main(_eval_prepare, cfg)


def cmd_eval(cfg: Config) -> None:
    _on_main(_eval, cfg)


def cmd_run(cfg: Config) -> None:
    """run.sh: optimize train -> optimize test -> eval prepare -> eval
    (``run.sh:9-23``); the eval's lines also go to <out_dir>/<ds>-<ver>.txt."""
    import contextlib
    import io
    import os

    cfg.mode = "train"
    cmd_optimize(cfg)
    cfg.mode = "test"
    cmd_optimize(cfg)

    def evaluate(cfg):
        _eval_prepare(cfg)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _eval(cfg)
        text = buf.getvalue()
        print(text, end="")
        os.makedirs(cfg.out_dir, exist_ok=True)
        with open(f"{cfg.out_dir}/{cfg.dataset}-{cfg.ver}.txt", "w") as f:
            f.write(text)

    _on_main(evaluate, cfg)


ABLATIONS = {
    # reference src/job.sh:9-18
    "full": {},
    "wo_s": {"w_s": 0.0},
    "wo_c": {"w_c": 0.0},
    "wo_adv": {"w_adv": 0.0},
    "wo_bt": {"w_bt": 0.0},
    "wo_allc": {"w_c": 0.0, "w_bt": 0.0},
}


def cmd_ablate(cfg: Config) -> None:
    import dataclasses

    from .train.warmup import run_warmup

    run_warmup(cfg)
    for ver, overrides in ABLATIONS.items():
        sub = dataclasses.replace(cfg, ver=ver, mode="train", **overrides)
        cmd_optimize(sub)
        sub.mode = "test"
        cmd_optimize(sub)
        cmd_eval_prepare(sub)
        cmd_eval(sub)


def cmd_serve(cfg: Config) -> None:
    """Read ``<style>\\t<text>`` lines (or bare text, style 0) from stdin,
    print each transferred text. Uses the newest optimize checkpoint, else the
    warmup G. Every batch is padded to ``batch_size`` rows, as the JAX package
    pads to its compiled shape, so each batch decodes at one shape: on the
    card a greedy batch replays one CUDA graph of the decode
    (``train/infer.py::make_transfer_step``), read back before the next.

    One process: the JAX ``serve`` feeds the whole batch to every device,
    so a mesh there only repeats the work; under the launcher with more
    than one rank it raises.

    When spans record (``utils/profiling.py``), each batch makes
    ``serve.read`` (waiting on stdin until the batch is full or the input
    ends), ``serve.encode`` (tokenising and padding), ``serve.step`` (the
    copy to the device, the decode, the copy back) and ``serve.decode_print``
    (detokenising and printing)."""
    import torch

    if world_size() > 1:
        raise RuntimeError("serve runs in one process; start it without torch.distributed.run")

    from .data.noise import align
    from .train.common import build_generator, get_device, get_tokenizer
    from .train.infer import make_transfer_step
    from .train.optimize import load_generator_params
    from .utils.profiling import span

    cfg.mode = "test"
    device = get_device(cfg)
    tokenizer = get_tokenizer(cfg)
    model = build_generator(cfg, len(tokenizer), device)
    load_generator_params(cfg, model)
    step = make_transfer_step(model, cfg.beam_size)

    def batches():
        """(styles, texts) of each batch of stdin's lines, the last one short."""
        styles, texts = [], []
        for line in sys.stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                s, text = line.split("\t", 1)
                styles.append(int(s))
            else:
                styles.append(0)
                text = line
            texts.append(text)
            if len(texts) == cfg.batch_size:
                yield styles, texts
                styles, texts = [], []
        if texts:
            yield styles, texts

    def flush(styles, texts):
        with span("serve.encode"):
            enc = [tokenizer.encode(t)[: cfg.max_len] for t in texts]
            n = len(enc)
            styles = list(styles)
            while len(enc) < cfg.batch_size:  # pad to the fixed batch shape
                enc.append([])
                styles.append(0)
            x, _ = align(enc, 0, cfg.max_len)
        with span("serve.step"):
            ids = step(torch.from_numpy(x).to(device),
                       torch.tensor(styles, dtype=torch.int32, device=device)).cpu().numpy()
        with span("serve.decode_print"):
            for i in range(n):
                print(tokenizer.decode(ids[i].tolist()), flush=True)

    feed = batches()
    while True:
        with span("serve.read"):
            batch = next(feed, None)
        if batch is None:
            return
        flush(*batch)


COMMANDS = {
    "vocab": cmd_vocab,
    "w2v": cmd_w2v,
    "pretrain": cmd_pretrain,
    "warmup": cmd_warmup,
    "optimize": cmd_optimize,
    "infer": cmd_infer,
    "eval-prepare": cmd_eval_prepare,
    "eval": cmd_eval,
    "run": cmd_run,
    "ablate": cmd_ablate,
    "serve": cmd_serve,
}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    command = argv[0]
    if command in NOT_PORTED:
        print(f"command {command!r} is not ported to PyTorch yet; see ROADMAP.md "
              f"(ported: {sorted(COMMANDS)})", file=sys.stderr)
        raise SystemExit(2)
    if command not in COMMANDS:
        print(f"unknown command {command!r}; one of {sorted(COMMANDS)}", file=sys.stderr)
        raise SystemExit(2)
    import time

    from .parallel.mesh import rank
    from .utils.profiling import report_launches, trace

    cfg = config_from_args(argv[1:])
    owned = init_distributed(cfg)  # the launcher's group, if it started this process
    t0 = time.perf_counter()
    try:
        with trace():  # a torch.profiler trace of the command when TPUST_TRACE=1
            COMMANDS[command](cfg)
        report_launches(command, time.perf_counter() - t0, rank())  # TPUST_KERNEL_COUNTS=1
    finally:
        if owned:
            destroy_distributed()


if __name__ == "__main__":
    main()
