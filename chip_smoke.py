#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``consistent__style_transfer_torch``)
on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py        # from the root of a checkout; needs CUDA and nvcc

Phases, in order; any failure exits non-zero before the last line:
1. the card's name and power limit (nvidia-smi), and the build of every
   kernel from the checkout's sources (``build/torch_kernels/``), one nvcc
   per source, all started together;
2. every kernel against its plain PyTorch version on the card, at the shapes
   its path gives it, with times (CUDA events) and the bound: the decode head
   at the serving shapes, the Sinkhorn through both of its names at the yelp
   and book WMD-label shapes, a ragged shape, all-zero pairs and B=1;
3. ``serve`` and ``infer`` through the port's CLI on the committed yelp test
   split (BPE trained on the yelp train split, fresh seeded weights saved as a
   checkpoint), with the decode head's launch count read around each; and
   the card's greedy ids held against the CPU's on a few sentences in float32;
4. greedy transfer at the full yelp width (V=10000, L=18, B=256, bf16):
   ms per batch, sentences/s and a profiler breakdown;
5. ``pretrain --epochs 1`` through the port's CLI at the full yelp width
   (the three scorers at 6 layers / 8 heads / d=512, B=256, L=18, bf16
   autocast) on the committed yelp corpus, after a one-epoch word2vec: the
   checkpoints load strictly, every logged loss is finite, and the Sinkhorn
   kernel launched once per labeled batch; then ms per step, sentences/s,
   the Sinkhorn on a real label batch, and a profiler breakdown.
Then one JSON line of kernel numbers and, last, the device line.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
YELP_V, YELP_L, YELP_B, DIN, HID = 10000, 18, 256, 1024, 512
# NVIDIA H100 SXM data sheet: HBM rate and dense peaks (tensor-core bf16; f32
# outside the tensor cores, which is what a float32 product without TF32 gets)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCES = ("decode_step", "sinkhorn")
SINKHORN_EPS, SINKHORN_ITERS = 0.05, 100


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of fn() over back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def phase_card_and_build() -> str:
    from consistent__style_transfer_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    built, errors = {}, {}

    def build(name):
        t0 = time.perf_counter()
        try:
            built[name] = (_build.build(name), time.perf_counter() - t0)
        except Exception as e:  # reported below: the phase fails
            errors[name] = e

    threads = [threading.Thread(target=build, args=(n,)) for n in KERNEL_SOURCES]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"kernel build failed: {errors}")
    print(json.dumps({"build": {name: {"library": os.path.relpath(path, ROOT),
                                       "seconds": round(sec, 3)}
                                for name, (path, sec) in built.items()},
                      "build_wall_s": round(wall, 3)}), flush=True)
    for name, (path, _) in built.items():
        with open(path[: -len(".so")] + ".log") as f:
            log(f"nvcc report, {name}:\n" + f.read())
    return card


# ------------------------------------------------------------------ phase 2
def head_inputs(B: int, V: int, dtype, seed: int):
    """x = [o_t; a_t] in (-1, 1) and weights with the generator's init
    distributions, in nn.Linear layout, made on the CPU from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def u(shape, bound):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    t = (u((B, DIN), 1.0), u((HID, DIN), DIN ** -0.5), u((HID,), DIN ** -0.5),
         u((V, HID), HID ** -0.5))
    return [a.to("cuda", dtype).contiguous() for a in t]


def head_bound(B: int, V: int, dtype_name: str) -> tuple[float, str]:
    """Least time for the head's work on the card: inputs read once, outputs
    (h f32, ids int32) written once, against the operations at the type's peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = (B * DIN + HID * DIN + HID + V * HID) * elem + B * HID * 4 + B * 4
    ops = 2 * B * DIN * HID + 2 * B * HID * V
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_vs_plain() -> dict:
    import torch
    import torch.nn.functional as F

    from consistent__style_transfer_torch.kernels.decode_step import (
        decode_head_reference,
        fused_decode_logits,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain version in full f32
    checks, timed = [], {}
    shapes = [(YELP_B, YELP_V), (YELP_B, 5317), (1, YELP_V), (200, YELP_V)]
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for seed, (B, V) in enumerate(shapes):
            x, w1, b1, w2 = head_inputs(B, V, dtype, seed)
            ids, h = fused_decode_logits(x, w1, b1, w2)
            ref_ids, ref_h = decode_head_reference(x, w1, b1, w2)
            torch.cuda.synchronize()
            check(ids.dtype == torch.int32 and ids.shape == (B,) and h.shape == (B, HID),
                  "kernel output shapes")
            err_h = (h - ref_h.float()).abs().max().item()
            mismatch = (ids != ref_ids).nonzero().flatten()
            # the same function in f32 on the same (rounded) inputs
            h32 = decode_head_reference(x.float(), w1.float(), b1.float(), w2.float())[1]
            logits32 = h32 @ w2.float().t()
            err_h32 = (h - h32).abs().max().item()
            row = {"dtype": dtype_name, "B": B, "V": V, "max_abs_err_h": err_h,
                   "max_abs_err_h_vs_f32": err_h32, "ids_mismatch": int(mismatch.numel())}
            if dtype_name == "float32":
                # same f32 sums in another order: ids exact, h within 1e-4
                check(mismatch.numel() == 0, f"f32 ids differ at rows {mismatch.tolist()[:8]}")
                check(err_h <= 1e-4, f"f32 h differs by {err_h}")
            else:
                # bf16: h within 2e-2 of the plain bf16 h relative to its size;
                # a differing id must be a near-tie of the f32 logits
                scale = ref_h.float().abs().max().item()
                check(err_h <= 2e-2 * scale, f"bf16 h differs by {err_h} (|h| max {scale})")
                check(err_h32 <= 1e-4, f"bf16-input h differs from f32 math by {err_h32}")
                if mismatch.numel():
                    rows = mismatch
                    gap = (logits32[rows].max(-1).values
                           - logits32[rows, ids[rows].long()]).max().item()
                    row["max_logit_gap"] = gap
                    check(gap <= 1e-2, f"bf16 id off the f32 max by {gap}")
            checks.append(row)
            if B == YELP_B and V == YELP_V:
                bound_ms, bound_by = head_bound(B, V, dtype_name)

                def library():
                    h_lib = F.leaky_relu(torch.addmm(b1, x, w1.t()), 0.1)
                    return torch.matmul(h_lib, w2.t()).argmax(-1)

                timed[dtype_name] = {
                    "kernel_ms": time_ms(lambda: fused_decode_logits(x, w1, b1, w2)),
                    "plain_ms": time_ms(lambda: decode_head_reference(x, w1, b1, w2)),
                    "library_ms": time_ms(library),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err_h": err_h, "ids_mismatch": int(mismatch.numel()),
                }
    print(json.dumps({"kernel_checks": checks}), flush=True)
    print(json.dumps({"decode_head_times_yelp": timed}), flush=True)
    return timed


def sinkhorn_inputs(B: int, N: int, M: int, seed: int, lengths=None):
    """p, q with zero tails (row b keeps n_b, m_b atoms: ``lengths`` or drawn
    from [N//4, N], [M//4, M]) and D between unit vectors of dimension 100,
    built as the WMD labeler builds it; made on the CPU from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if lengths is None:
        n_on = torch.randint(max(1, N // 4), N + 1, (B,), generator=g)
        m_on = torch.randint(max(1, M // 4), M + 1, (B,), generator=g)
    else:
        n_on, m_on = torch.full((B,), lengths[0]), torch.full((B,), lengths[1])
    p = (torch.rand(B, N, generator=g) + 0.05) * (torch.arange(N) < n_on[:, None])
    q = (torch.rand(B, M, generator=g) + 0.05) * (torch.arange(M) < m_on[:, None])
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-9)
    q = q / q.sum(-1, keepdim=True).clamp_min(1e-9)
    x = torch.nn.functional.normalize(torch.randn(B, N, 100, generator=g), dim=-1)
    y = torch.nn.functional.normalize(torch.randn(B, M, 100, generator=g), dim=-1)
    diff = x[:, :, None, :] - y[:, None, :, :]
    D = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 1e-12))
    return [t.cuda().contiguous() for t in (p, q, D)]


def sinkhorn_bound(p, q) -> tuple[float, str]:
    """Least time for one Sinkhorn call on these inputs: p, q, D read once
    and the costs written once, against the work these masks need: 5 f32
    operations (add, max, subtract, exp, add) per valid (i, j) term of each
    of the 2 * n_iters masked logsumexps, at the f32 peak."""
    B, N = p.shape
    M = q.shape[1]
    nbytes = (B * N + B * M + B * N * M + B) * 4
    valid = ((p > 0).sum(-1) * (q > 0).sum(-1)).sum().item()
    ops = 5 * 2 * SINKHORN_ITERS * valid
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_sinkhorn_vs_plain() -> dict:
    """Both names against the plain version at every stated shape; rtol
    1e-4, atol 1e-5 (tests/test_kernels.py:35: the same f32 terms summed in
    another order). Times at the yelp shape."""
    import torch

    from consistent__style_transfer_torch.kernels.sinkhorn import (
        sinkhorn_pallas,
        sinkhorn_pallas_cr,
    )
    from consistent__style_transfer_torch.ops.emd import sinkhorn_ot_cost

    cases = [("yelp", 256, 27, 27, None), ("book", 128, 45, 45, None),
             ("ragged", 5, 9, 7, (7, 5)), ("single", 1, 27, 27, None),
             ("zero_pairs", 6, 27, 27, None)]
    checks, worst = [], 0.0
    for seed, (name, B, N, M, lengths) in enumerate(cases):
        p, q, D = sinkhorn_inputs(B, N, M, seed, lengths)
        if name == "zero_pairs":  # fallback rows: both sides zeroed, or one
            p[:3] = 0
            q[:2] = 0
            q[3] = 0
        ref = sinkhorn_ot_cost(p, q, D, SINKHORN_EPS, SINKHORN_ITERS)
        for entry in (sinkhorn_pallas, sinkhorn_pallas_cr):
            got = entry(p, q, D, SINKHORN_EPS, SINKHORN_ITERS)
            torch.cuda.synchronize()
            check(got.shape == (B,) and bool(torch.isfinite(got).all()),
                  f"sinkhorn {name}: shape {tuple(got.shape)} or non-finite values")
            err = (got - ref).abs().max().item()
            check(bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-5)),
                  f"{entry.__name__} {name}: max abs err {err}")
            if name == "zero_pairs":
                check(bool((got[:4] == 0).all()), f"{entry.__name__}: all-zero pairs gave {got[:4]}")
            worst = max(worst, err)
            checks.append({"entry": entry.__name__, "case": name, "B": B, "N": N, "M": M,
                           "max_abs_err": err})
    p, q, D = sinkhorn_inputs(256, 27, 27, 0)
    bound_ms, bound_by = sinkhorn_bound(p, q)
    timed = {"B": 256, "N": 27, "M": 27,
             "kernel_ms": time_ms(lambda: sinkhorn_pallas(p, q, D), iters=100),
             "kernel_cr_ms": time_ms(lambda: sinkhorn_pallas_cr(p, q, D), iters=100),
             "plain_ms": time_ms(lambda: sinkhorn_ot_cost(p, q, D), iters=5, warmup=2),
             "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": worst}
    print(json.dumps({"sinkhorn_checks": checks}), flush=True)
    print(json.dumps({"sinkhorn_times_yelp_synthetic": timed}), flush=True)
    return timed


# ------------------------------------------------------------------ phase 3
def run_cli(argv: list[str], stdin_text: str = "") -> list[str]:
    from consistent__style_transfer_torch import cli

    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    finally:
        sys.stdin = old_stdin
    return out.getvalue().splitlines()


def phase_serve_and_infer(work: str) -> dict:
    import numpy as np
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.noise import align
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.train.common import build_generator, get_tokenizer
    from consistent__style_transfer_torch.train.infer import make_transfer_step
    from consistent__style_transfer_torch.train.optimize import load_generator_params

    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("yelp", **dirs)
    t0 = time.perf_counter()
    tokenizer = get_tokenizer(cfg)  # trains the BPE on data/yelp/style.train.*
    V = len(tokenizer)
    log(f"BPE trained in {time.perf_counter() - t0:.1f} s: V={V}")
    ckpt = os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}", "G_epoch_1.pth")
    os.makedirs(os.path.dirname(ckpt))
    torch.save(DenoiseSeq2Seq(n_vocab=V, n_class=cfg.n_class, max_len=cfg.max_len,
                              seed=0).state_dict(), ckpt)

    requests = []
    for label in (0, 1):
        with open(os.path.join(cfg.ds_data_dir, f"style.test.{label}"), encoding="utf-8") as f:
            requests += [f"{label}\t{line.strip()}" for line in f if line.strip()]
    serve_batches = -(-len(requests) // cfg.batch_size)

    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0
    t0 = time.perf_counter()
    served = run_cli(["serve", *flags], "\n".join(requests) + "\n")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = fused_decode_logits.launches
    check(sinkhorn_cuda.launches == 0, "serve launched the Sinkhorn")
    check(len(served) == len(requests), f"serve printed {len(served)} lines for {len(requests)}")
    check(serve_launches == cfg.max_len * serve_batches,
          f"serve: {serve_launches} kernel launches, want {cfg.max_len} x {serve_batches}")

    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0
    t0 = time.perf_counter()
    run_cli(["infer", *flags])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_launches = fused_decode_logits.launches
    check(sinkhorn_cuda.launches == 0, "infer launched the Sinkhorn")
    infer_batches, n_infer = 0, 0
    for split in ("train", "test"):
        n_split = 0
        for label in (0, 1):
            with open(os.path.join(cfg.ds_data_dir, f"style.{split}.{label}"), encoding="utf-8") as f:
                want = sum(1 for line in f if line.strip())
            path = os.path.join(cfg.run_out_dir, f"style.{split}.{label}.tsf")
            check(os.path.exists(path), f"missing {path}")
            with open(path, encoding="utf-8") as f:
                got = len(f.read().splitlines())
            check(got == want, f"{path}: {got} lines, want {want}")
            n_split += want
        infer_batches += -(-n_split // cfg.batch_size)
        n_infer += n_split
    check(infer_launches == cfg.max_len * infer_batches,
          f"infer: {infer_launches} kernel launches, want {cfg.max_len} x {infer_batches}")

    # reference on a small input: the card's greedy ids (kernel head) equal the
    # CPU's (plain head) in float32 on the same checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = make_config("yelp", dtype="float32", mode="test", **dirs)
    enc = [tokenizer.encode(r.split("\t", 1)[1])[: cfg.max_len] for r in requests[::125]]
    x, _ = align(enc, 0, cfg.max_len)
    labels = np.array([int(r[0]) for r in requests[::125]], np.int32)
    ids = {}
    for dev in ("cuda", "cpu"):
        model = build_generator(cfg32, V, torch.device(dev))
        load_generator_params(cfg32, model)
        ids[dev] = make_transfer_step(model)(torch.from_numpy(x).to(dev),
                                             torch.from_numpy(labels).to(dev)).cpu()
    agree = (ids["cuda"] == ids["cpu"]).float().mean().item()
    check(agree == 1.0, f"f32 greedy ids on the card agree with the CPU on {agree:.3f} of tokens")

    result = {"V": V, "serve_requests": len(requests), "serve_batches": serve_batches,
              "serve_s": serve_s, "serve_sent_per_s": len(requests) / serve_s,
              "serve_launches": serve_launches, "infer_sentences": n_infer,
              "infer_batches": infer_batches, "infer_s": infer_s,
              "infer_sent_per_s": n_infer / infer_s, "infer_launches": infer_launches,
              "f32_card_vs_cpu_sentences": len(enc), "f32_card_vs_cpu_agree": agree}
    print(json.dumps({"serve_infer": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 4
def profile_breakdown(fn, batches: int = 3, watch: tuple[str, ...] = ()) -> dict:
    """Device time per call of fn by kernel name (torch.profiler): the sum of
    the kernels' own device time, user annotations (such as the optimizer's
    ranges) left out; ``watch`` names kernels reported whatever their rank.
    Where the profiler gives no device time, the breakdown says "not
    measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
    except RuntimeError as e:  # the tracer itself, not the path under test
        return {"device_ms_per_batch": "not measured", "error": str(e)[:200]}

    by_name: dict[str, list[float]] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    total = sum(us for us, _ in by_name.values())
    if not total:
        return {"device_ms_per_batch": "not measured"}

    def row(name):
        us, count = by_name[name]
        return {"name": name[:80], "ms_per_batch": us / batches / 1e3,
                "calls_per_batch": count / batches}

    top = sorted(by_name, key=lambda n: by_name[n][0], reverse=True)
    return {"device_ms_per_batch": total / batches / 1e3,
            "kernels_per_batch": sum(c for _, c in by_name.values()) / batches,
            "top": [row(n) for n in top[:10]],
            "watched": [row(n) for n in top if any(w in n for w in watch)]}


def phase_full_width(card: str) -> dict:
    import torch

    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.train.infer import make_transfer_step

    model = DenoiseSeq2Seq(n_vocab=YELP_V, n_class=2, max_len=YELP_L, seed=0)
    model = model.to("cuda", torch.bfloat16).eval()
    step = make_transfer_step(model)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(3, YELP_V, (YELP_B, YELP_L), generator=g, dtype=torch.int32).cuda()
    labels = torch.randint(0, 2, (YELP_B,), generator=g, dtype=torch.int32).cuda()
    for _ in range(3):
        step(x, labels)
    torch.cuda.synchronize()

    n = 20
    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(n):
        ids = step(x, labels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    launches = fused_decode_logits.launches
    check(sinkhorn_cuda.launches == 0, "serving launched the Sinkhorn")
    check(launches == YELP_L * n, f"full width: {launches} launches, want {YELP_L} x {n}")
    check(ids.shape == (YELP_B, YELP_L) and ids.dtype == torch.int32, "ids shape/dtype")
    check(bool(((ids >= 0) & (ids < YELP_V)).all()), "ids out of range")

    breakdown = profile_breakdown(lambda: step(x, labels))
    result = {"card": card, "dtype": "bfloat16", "V": YELP_V, "L": YELP_L, "B": YELP_B,
              "ms_per_batch": ms, "sent_per_s": YELP_B * 1e3 / ms,
              "launches_per_batch": launches / n, "profile": breakdown}
    print(json.dumps({"full_width": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 5
def count_lines(files) -> int:
    n = 0
    for path in files:
        with open(path, encoding="utf-8") as f:
            n += sum(1 for line in f if line.strip())
    return n


def phase_pretrain(work: str, card: str) -> dict:
    import numpy as np
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.noise import transfer_noise_arrays
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import (
        sinkhorn_cuda,
        sinkhorn_pallas,
        sinkhorn_pallas_cr,
    )
    from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM
    from consistent__style_transfer_torch.ops.emd import sinkhorn_ot_cost
    from consistent__style_transfer_torch.text.word2vec import train_token_w2v
    from consistent__style_transfer_torch.train.common import (
        build_classifier,
        build_lm,
        build_matcher,
        get_corpus,
        get_tokenizer,
        get_w2v,
    )
    from consistent__style_transfer_torch.train.pretrain import TASKS, make_pretrain_steps
    from consistent__style_transfer_torch.train.state import AdamWithClip

    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"), log_dir=os.path.join(work, "log"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("yelp", **dirs)
    B, L = cfg.batch_size, cfg.max_len
    tokenizer = get_tokenizer(cfg)  # phase 3's BPE dump
    V = len(tokenizer)
    # a stated reduction: one word2vec epoch instead of get_w2v's ten
    t0 = time.perf_counter()
    train_token_w2v(cfg.train_files(), tokenizer, epochs=1, seed=cfg.seed).save(cfg.w2v_path)
    w2v_s = time.perf_counter() - t0
    log(f"word2vec (1 epoch, numpy) in {w2v_s:.1f} s")
    n_train, n_dev = count_lines(cfg.train_files()), count_lines(cfg.split_files("dev"))
    labeled = n_train // B + -(-n_dev // B)  # train drops its last partial batch

    sinkhorn_cuda.launches = 0
    fused_decode_logits.launches = 0
    t0 = time.perf_counter()
    run_cli(["pretrain", *flags, "--epochs", "1"])
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    launches = sinkhorn_cuda.launches
    check(launches == labeled,
          f"pretrain: {launches} Sinkhorn launches, want one per labeled batch = {labeled}")
    check(fused_decode_logits.launches == 0, "pretrain launched the decode head")

    for task, cls in (("cls", TextCNN), ("mat", PairMatcher), ("dn", TransformerLM)):
        path = os.path.join(cfg.ds_dump_dir, "pretrain", f"{task}.pth")
        check(os.path.exists(path), f"missing {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        cls(V).load_state_dict(sd, strict=True)
        check(all(bool(torch.isfinite(v).all()) for v in sd.values()), f"{path}: non-finite weights")
    with open(os.path.join(cfg.log_dir, cfg.dataset, "pretrain", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    losses = {k: v for e in events for k, v in e.items()
              if k.endswith("_loss") or k.startswith("val_")}
    check(bool(losses) and all(np.isfinite(v) for v in losses.values()),
          f"non-finite logged loss: {losses}")
    epoch = [e for e in events if "train_steps" in e][-1]
    check(epoch["train_steps"] == n_train // B, f"trained {epoch['train_steps']} steps")
    ms_per_step = epoch["train_s"] * 1e3 / epoch["train_steps"]

    # the Sinkhorn on one real label batch (after the counts were read)
    labeler = SinkhornWmdLabeler(get_w2v(cfg, tokenizer), tokenizer, max_atoms=L + L // 2,
                                 device=torch.device("cuda"))
    corpus = get_corpus(cfg, "train", tokenizer)
    rng = np.random.default_rng(0)
    noise_len = L + max(4, L // 2)
    ids, lens = corpus.ids[:B], corpus.lengths[:B]
    nx1, nl1 = transfer_noise_arrays(ids, lens, 0.15, rng, noise_len)
    nx2, nl2 = transfer_noise_arrays(ids, lens, 0.15, rng, noise_len)
    p, q, D, _ = labeler.pair_inputs(nx1, nl1, nx2, nl2)
    ref = sinkhorn_ot_cost(p, q, D)
    err = max((entry(p, q, D) - ref).abs().max().item()
              for entry in (sinkhorn_pallas, sinkhorn_pallas_cr))
    check(err <= 1e-5 + 1e-4 * ref.abs().max().item(), f"Sinkhorn on a label batch: err {err}")
    bound_ms, bound_by = sinkhorn_bound(p, q)
    for _ in range(2):
        labeler.label_pairs(nx1, nl1, nx2, nl2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        labeler.pair_inputs(nx1, nl1, nx2, nl2)
    torch.cuda.synchronize()
    pair_inputs_ms = (time.perf_counter() - t0) * 1e2
    t0 = time.perf_counter()
    for _ in range(10):
        labeler.label_pairs(nx1, nl1, nx2, nl2)
    torch.cuda.synchronize()
    label_pairs_ms = (time.perf_counter() - t0) * 1e2
    real = {"B": B, "atoms": (p.shape[1], q.shape[1]),
            "pair_inputs_ms_host": pair_inputs_ms, "label_pairs_ms_host": label_pairs_ms,
            "valid_terms_per_iter": int(((p > 0).sum(-1) * (q > 0).sum(-1)).sum()),
            "kernel_ms": time_ms(lambda: sinkhorn_pallas(p, q, D), iters=100),
            "kernel_cr_ms": time_ms(lambda: sinkhorn_pallas_cr(p, q, D), iters=100),
            "plain_ms": time_ms(lambda: sinkhorn_ot_cost(p, q, D), iters=5, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}

    # steady state and profile: the same full-width towers and step, on
    # batches from the prefetcher with the labeler, as in the run above
    device = torch.device("cuda")
    models = {"cls": build_classifier(cfg, V, device), "mat": build_matcher(cfg, V, device),
              "dn": build_lm(cfg, V, device)}
    optimizer = AdamWithClip([p for t in TASKS for p in models[t].parameters()],
                             cfg.pretrain_lr, cfg.pretrain_clip)
    train_step, _ = make_pretrain_steps(models, optimizer, autocast_dtype=torch.bfloat16)
    generator = torch.Generator(device).manual_seed(0)
    it = make_batches(corpus, B, L, "pretrain", shuffle=True, seed=1, wmd_labeler=labeler)
    stream = iter(DevicePrefetcher(it, device))
    try:
        def step():
            return train_step(next(stream)[1], (True, True, True), generator)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            parts = step()
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) * 1e3 / n
        check(all(bool(torch.isfinite(v)) for v in parts.values()), f"non-finite losses {parts}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        breakdown = profile_breakdown(step, batches=4, watch=("sinkhorn",))
    finally:
        stream.close()
    device_ms = breakdown.get("device_ms_per_batch")
    idle = (1 - device_ms / steady_ms) if isinstance(device_ms, float) else "not measured"
    result = {"card": card, "dtype": "bfloat16 autocast, float32 parameters", "V": V, "L": L,
              "B": B, "scorer": "6 layers / 8 heads / d=512", "w2v_epochs": 1, "w2v_s": w2v_s,
              "train_sentences": n_train, "dev_sentences": n_dev, "pretrain_cli_s": pretrain_s,
              "train_steps": epoch["train_steps"], "ms_per_step_epoch": ms_per_step,
              "sent_per_s_epoch": B * 1e3 / ms_per_step, "ms_per_step_steady": steady_ms,
              "sent_per_s_steady": B * 1e3 / steady_ms, "peak_memory_gb_steady": peak_gb,
              "sinkhorn_launches": launches, "labeled_batches": labeled,
              "sinkhorn_label_batch": real, "device_idle_share": idle,
              "profile_per_step": breakdown,
              "val": {k: v for k, v in epoch.items() if k.startswith("val")}}
    print(json.dumps({"pretrain": result}), flush=True)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    import consistent__style_transfer_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = phase_card_and_build()
    timed = phase_kernel_vs_plain()
    sinkhorn = phase_sinkhorn_vs_plain()
    with tempfile.TemporaryDirectory() as work:
        served = phase_serve_and_infer(work)
        full = phase_full_width(card)
        pre = phase_pretrain(work, card)

    yelp = timed["bfloat16"]
    real = pre["sinkhorn_label_batch"]
    sinkhorn_rows = [{
        "name": name,
        "route": "cuda",
        "source": "consistent__style_transfer_torch/csrc/sinkhorn.cu",
        "replaces": f"consistent__style_transfer_tpu/kernels/sinkhorn.py:{line}",
        # one CUDA kernel behind both names: its launches, through either
        "launches": pre["sinkhorn_launches"],
        "launch_counter": "sinkhorn_cuda.launches (one kernel behind both names)",
        "launches_per_batch": 1,
        "max_abs_err": max(real["max_abs_err"], sinkhorn["max_abs_err"]),
        "ms": real[ms_key],
        "kernel_ms": real[ms_key],
        "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"],
        "bound_by": real["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a Sinkhorn
        "shape": {"B": real["B"], "N": real["atoms"][0], "M": real["atoms"][1],
                  "dtype": "float32", "inputs": "one yelp WMD-label batch"},
        "synthetic_yelp": sinkhorn,
    } for name, line, ms_key in (("sinkhorn_pallas", 178, "kernel_ms"),
                                 ("sinkhorn_pallas_cr", 129, "kernel_cr_ms"))]
    print(json.dumps({"kernels": [{
        "name": "fused_decode_logits",
        "route": "cuda",
        "source": "consistent__style_transfer_torch/csrc/decode_step.cu",
        "replaces": "consistent__style_transfer_tpu/kernels/decode_step.py:73",
        "launches": served["serve_launches"] + served["infer_launches"],
        "launches_per_batch": full["launches_per_batch"],
        "max_abs_err": yelp["max_abs_err_h"],
        "max_abs_err_h": yelp["max_abs_err_h"],
        "ids_mismatch": yelp["ids_mismatch"],
        "ms": yelp["kernel_ms"],
        "kernel_ms": yelp["kernel_ms"],
        "plain_ms": yelp["plain_ms"],
        "bound_ms": yelp["bound_ms"],
        "bound_by": yelp["bound_by"],
        "library_ms": yelp["library_ms"],
        "shape": {"B": YELP_B, "Din": DIN, "H": HID, "V": YELP_V, "dtype": "bfloat16"},
        "float32": timed["float32"],
    }, *sinkhorn_rows]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
