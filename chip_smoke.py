#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``consistent__style_transfer_torch``)
on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py        # from the root of a checkout; needs CUDA and nvcc

Phases, in order; any failure exits non-zero before the last line:
1. the card's name and power limit (nvidia-smi), and the build of every
   kernel of the path from the checkout's sources (``build/torch_kernels/``);
2. every kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it, with times (CUDA events) and the bound;
3. ``serve`` and ``infer`` through the port's CLI on the committed yelp test
   split (BPE trained on the yelp train split, fresh seeded weights saved as a
   checkpoint), with the kernel's launch count read around each; and the
   card's greedy ids held against the CPU's on a few sentences in float32;
4. greedy transfer at the full yelp width (V=10000, L=18, B=256, bf16):
   ms per batch, sentences/s and a profiler breakdown.
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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
YELP_V, YELP_L, YELP_B, DIN, HID = 10000, 18, 256, 1024, 512
# NVIDIA H100 SXM data sheet: HBM rate and dense peaks (tensor-core bf16; f32
# outside the tensor cores, which is what a float32 product without TF32 gets)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}


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
    t0 = time.perf_counter()
    path = _build.build("decode_step")
    seconds = time.perf_counter() - t0
    print(json.dumps({"build": {"decode_step": os.path.relpath(path, ROOT),
                                "seconds": round(seconds, 3)}}), flush=True)
    with open(path[: -len(".so")] + ".log") as f:
        log("nvcc report:\n" + f.read())
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
    t0 = time.perf_counter()
    served = run_cli(["serve", *flags], "\n".join(requests) + "\n")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = fused_decode_logits.launches
    check(len(served) == len(requests), f"serve printed {len(served)} lines for {len(requests)}")
    check(serve_launches == cfg.max_len * serve_batches,
          f"serve: {serve_launches} kernel launches, want {cfg.max_len} x {serve_batches}")

    fused_decode_logits.launches = 0
    t0 = time.perf_counter()
    run_cli(["infer", *flags])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_launches = fused_decode_logits.launches
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
def profile_breakdown(fn, batches: int = 3) -> dict:
    """Device time per batch by kernel name (torch.profiler). Where the
    profiler gives no device time, the breakdown says "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
    except RuntimeError as e:  # the tracer itself, not the path under test
        return {"device_ms_per_batch": "not measured", "error": str(e)[:200]}

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in averages if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(device_us(e) for e in kernels)
    if not total:
        return {"device_ms_per_batch": "not measured"}
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    return {"device_ms_per_batch": total / batches / 1e3,
            "top": [{"name": e.key[:80], "ms_per_batch": device_us(e) / batches / 1e3,
                     "calls_per_batch": e.count / batches} for e in top]}


def phase_full_width(card: str) -> dict:
    import torch

    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
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
    t0 = time.perf_counter()
    for _ in range(n):
        ids = step(x, labels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    launches = fused_decode_logits.launches
    check(launches == YELP_L * n, f"full width: {launches} launches, want {YELP_L} x {n}")
    check(ids.shape == (YELP_B, YELP_L) and ids.dtype == torch.int32, "ids shape/dtype")
    check(bool(((ids >= 0) & (ids < YELP_V)).all()), "ids out of range")

    breakdown = profile_breakdown(lambda: step(x, labels))
    result = {"card": card, "dtype": "bfloat16", "V": YELP_V, "L": YELP_L, "B": YELP_B,
              "ms_per_batch": ms, "sent_per_s": YELP_B * 1e3 / ms,
              "launches_per_batch": launches / n, "profile": breakdown}
    print(json.dumps({"full_width": result}), flush=True)
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
    with tempfile.TemporaryDirectory() as work:
        served = phase_serve_and_infer(work)
    full = phase_full_width(card)

    yelp = timed["bfloat16"]
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
    }]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
