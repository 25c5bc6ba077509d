#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``consistent__style_transfer_torch``)
on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py        # from the root of a checkout; needs CUDA and nvcc

Phases, in order; any failure exits non-zero before the last line:
1. the card's name and power limit (nvidia-smi), and the build of every
   kernel from the checkout's sources (``build/torch_kernels/``), one nvcc
   per source, all started together, with ptxas's registers, shared memory
   and spills per kernel and, where cuobjdump is installed, the count of
   HGMMA (wgmma) instructions in each library;
2. every kernel against its plain PyTorch version on the card, at the shapes
   its path gives it, with times and the bound: the decode head at the
   serving shapes (timed as CUDA graphs of 50 calls, so that a call of a few
   microseconds is not paced by the host, beside the eager back-to-back time,
   with its device operations per call from the profiler), the Sinkhorn
   through both of its names at the yelp and book WMD-label shapes, a ragged
   shape, all-zero pairs, B=1, masks with interior zeros, the 64 x 64 cap
   and B=257, then graph-timed and eager at the yelp and book shapes with its
   device operations per call, the bound (bytes, FMA work, special
   functions) and its share;
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
   kernel launched once per labeled batch; then the Sinkhorn on a real label
   batch (checked and timed as in phase 2, with the labeler's host
   times and its device time split into the Sinkhorn, the copies and the
   rest), ms per step, sentences/s, and a profiler breakdown.
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
# special-function units (exp2, log2): 16 results per SM per clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0), 132 SMs at the H100 SXM's 1.98 GHz boost clock
PEAK_SFU_S = 16 * 132 * 1.98e9
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


def graph_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """Mean device time of one fn() call: ``calls`` calls captured in a CUDA
    graph, its replays timed with CUDA events. The host issues one replay,
    not fn's Python and launches, so calls of a few microseconds are timed
    by the card."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def sass_count(library: str, opcode: str):
    """Instructions of ``opcode`` in a built library's SASS, or None where the
    toolkit has no cuobjdump."""
    from consistent__style_transfer_torch.kernels import _build

    tool = os.path.join(os.path.dirname(os.path.realpath(_build.nvcc_path())), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed on {library}: {out.stderr[:500]}")
    return sum(1 for line in out.stdout.splitlines() if opcode in line)


def ptxas_report(log_text: str) -> dict:
    """Per kernel (mangled name): ptxas's registers / shared memory line and
    its spill line."""
    report, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            report[name] = []
        elif name and ("Used" in line or "spill" in line):
            report[name].append(line.split(":", 1)[-1].strip())
    return {n: "; ".join(v) for n, v in report.items()}


# ------------------------------------------------------------------ phase 1
def phase_card_and_build() -> tuple[str, dict]:
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
    report = {}
    for name, (path, sec) in built.items():
        with open(path[: -len(".so")] + ".log") as f:
            text = f.read()
        log(f"nvcc report, {name}:\n" + text)
        report[name] = {"library": os.path.relpath(path, ROOT), "seconds": round(sec, 3),
                        "sass_hgmma": sass_count(path, "HGMMA"), "ptxas": ptxas_report(text)}
    hgmma = report["decode_step"]["sass_hgmma"]
    check(hgmma is None or hgmma > 0, "the decode head's library has no HGMMA instruction")
    print(json.dumps({"build": report, "build_wall_s": round(wall, 3)}), flush=True)
    return card, report


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


def head_times(x, w1, b1, w2, dtype_name: str, seed: int) -> dict:
    """The kernel, its plain version and the library call (PyTorch's addmm,
    leaky_relu, matmul and argmax) on the same inputs, each timed three ways:
    graph-timed with the inputs rotated through enough copies (seeded like
    the first) to exceed the 50 MB L2, so that every call reads its weights
    from device memory as the bound assumes ("ms"); graph-timed on the one
    set, L2-warm ("warm_ms"); and eagerly, back to back ("eager_ms"). Device
    operations per call come from the profiler."""
    import torch
    import torch.nn.functional as F

    from consistent__style_transfer_torch.kernels.decode_step import (
        decode_head_reference,
        fused_decode_logits,
    )

    B, V = x.shape[0], w2.shape[0]
    set_bytes = sum(t.numel() * t.element_size() for t in (x, w1, b1, w2))
    sets = [(x, w1, b1, w2)] + [head_inputs(B, V, x.dtype, seed + 100 * i)
                                for i in range(1, -(-60_000_000 // set_bytes) + 1)]

    def library(x, w1, b1, w2):
        return torch.matmul(F.leaky_relu(torch.addmm(b1, x, w1.t()), 0.1), w2.t()).argmax(-1)

    def rotating(fn):
        state = {"i": 0}

        def call():
            fn(*sets[state["i"] % len(sets)])
            state["i"] += 1
        return call

    bound_ms, bound_by = head_bound(B, V, dtype_name)
    out = {"B": B, "V": V, "Din": DIN, "H": HID, "dtype": dtype_name, "l2_cold_sets": len(sets),
           "bound_ms": bound_ms, "bound_by": bound_by}
    for key, fn in (("kernel", fused_decode_logits), ("plain", decode_head_reference),
                    ("library", library)):
        out[f"{key}_ms"] = graph_ms(rotating(fn), calls=len(sets) * max(1, 50 // len(sets)))
        out[f"{key}_warm_ms"] = graph_ms(lambda: fn(x, w1, b1, w2))
        out[f"{key}_eager_ms"] = time_ms(lambda: fn(x, w1, b1, w2))
        for _ in range(3):  # the tracer now and then returns no device events
            prof = profile_breakdown(lambda: fn(x, w1, b1, w2), batches=10)
            if "kernels_per_batch" in prof:
                break
        out[f"{key}_device_ops_per_call"] = prof.get("kernels_per_batch", "not measured")
        if key == "kernel":
            out["kernel_profile"] = prof.get("top", "not measured")
    out["bound_share"] = bound_ms / out["kernel_ms"]
    return out


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
            if B == YELP_B and V in (YELP_V, 5317):
                timed[f"{dtype_name}_V{V}"] = head_times(x, w1, b1, w2, dtype_name, seed)
                timed[f"{dtype_name}_V{V}"].update(max_abs_err_h=err_h,
                                                    ids_mismatch=int(mismatch.numel()))
    print(json.dumps({"kernel_checks": checks}), flush=True)
    print(json.dumps({"decode_head_times": timed}), flush=True)
    for name, t in timed.items():
        check(t["kernel_device_ops_per_call"] == 2,
              f"decode head {name}: {t['kernel_device_ops_per_call']} device operations per call")
    return timed


def sinkhorn_inputs(B: int, N: int, M: int, seed: int, lengths=None, scatter: bool = False):
    """p, q with zero tails (row b keeps n_b, m_b atoms: ``lengths`` or drawn
    from [N//4, N], [M//4, M]), or with the zeros anywhere (``scatter``), and
    D between unit vectors of dimension 100, built as the WMD labeler builds
    it; made on the CPU from a seed."""
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
    if scatter:  # each row's atoms in a random order: interior zeros
        rows = torch.arange(B)[:, None]
        p = p[rows, torch.argsort(torch.rand(B, N, generator=g), dim=1)]
        q = q[rows, torch.argsort(torch.rand(B, M, generator=g), dim=1)]
    x = torch.nn.functional.normalize(torch.randn(B, N, 100, generator=g), dim=-1)
    y = torch.nn.functional.normalize(torch.randn(B, M, 100, generator=g), dim=-1)
    diff = x[:, :, None, :] - y[:, None, :, :]
    D = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 1e-12))
    return [t.cuda().contiguous() for t in (p, q, D)]


def sinkhorn_bound(p, q) -> dict:
    """Least time for one Sinkhorn call on these inputs, for the least work
    the function needs (the kernel's product form: each logsumexp as a sum
    of E_ij * 2^(v_j - ref), E = 2^K): the largest of
    - bytes: p, q, D read once and the costs written once, at the HBM rate;
    - FMA work: one multiply-add (2 flop) per valid (i, j) term of each of
      the 2 * n_iters half-iterations, at the f32 peak;
    - special functions: one exp and one log per valid atom of each
      half-iteration, plus one exp per valid term for E and one for the
      plan and one log per valid atom for the masses, at the
      special-function rate.
    Only pairs whose masks leave some (i, j) count: the rest cost 0 without a
    loop. ``bound_by`` is "bytes" or "operations"; ``bound_term`` names the
    term."""
    B, N = p.shape
    M = q.shape[1]
    n, m = (p > 0).sum(-1), (q > 0).sum(-1)
    valid = int((n * m).sum())
    atoms = int(((n + m) * (n * m > 0)).sum())
    nbytes = (B * N + B * M + B * N * M + B) * 4
    fma = 2 * 2 * SINKHORN_ITERS * valid
    sfu = 2 * SINKHORN_ITERS * atoms + 2 * valid + atoms
    ms = {"bytes": nbytes / PEAK_BYTES_S * 1e3, "fma": fma / PEAK_OPS_S["float32"] * 1e3,
          "special_function": sfu / PEAK_SFU_S * 1e3}
    term = max(ms, key=ms.get)
    return {"bound_ms": ms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "valid_terms_per_iter": valid, "live_atoms": atoms,
            "bytes": nbytes, "fma_flop": fma, "special_function_ops": sfu,
            **{f"{k}_ms": v for k, v in ms.items()}}


def device_ops_per_call(fn, calls: int = 10):
    """Device operations per fn() call as the profiler counts them, or "not
    measured" (the tracer now and then returns no device events). It can
    also drop some: on a real yelp label batch it kept 7 of 10 Sinkhorn
    launches, try after try, so graph_nodes_per_call is the exact count."""
    for _ in range(3):
        prof = profile_breakdown(fn, batches=calls)
        if "kernels_per_batch" in prof:
            return prof["kernels_per_batch"]
    return "not measured"


def graph_nodes_per_call(fn) -> int:
    """Device operations one fn() call launches, exactly: the nodes (kernels,
    copies, memsets) of a CUDA graph that captures one call, counted by
    libcuda's cuGraphGetNodes."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    check(err == 0, f"cuGraphGetNodes failed: CUresult {err}")
    return count.value


def sinkhorn_times(p, q, D) -> dict:
    """Both names graph-timed (``graph_ms``: 50 calls a graph, so that the
    host does not set the pace) and eager back to back, their device
    operations per call (graph nodes, checked: 1; and the profiler's
    count), the plain version (eager, 5 calls: some 600 launches each), the
    bound and its share."""
    from consistent__style_transfer_torch.kernels.sinkhorn import (
        sinkhorn_pallas,
        sinkhorn_pallas_cr,
    )
    from consistent__style_transfer_torch.ops.emd import sinkhorn_ot_cost

    out = {"B": p.shape[0], "N": p.shape[1], "M": q.shape[1], **sinkhorn_bound(p, q)}
    for key, fn in (("kernel", sinkhorn_pallas), ("kernel_cr", sinkhorn_pallas_cr)):
        out[f"{key}_ms"] = graph_ms(lambda: fn(p, q, D))
        out[f"{key}_eager_ms"] = time_ms(lambda: fn(p, q, D), iters=100)
        out[f"{key}_device_ops_per_call"] = graph_nodes_per_call(lambda: fn(p, q, D))
        out[f"{key}_profiler_kernels_per_call"] = device_ops_per_call(lambda: fn(p, q, D))
    out["plain_ms"] = time_ms(lambda: sinkhorn_ot_cost(p, q, D), iters=5, warmup=2)
    out["bound_share"] = out["bound_ms"] / out["kernel_ms"]
    for key in ("kernel", "kernel_cr"):
        ops = out[f"{key}_device_ops_per_call"]
        check(ops == 1, f"Sinkhorn ({key}): {ops} device operations (graph nodes) per call, "
                        "want 1")
    return out


def phase_sinkhorn_vs_plain() -> dict:
    """Both names against the plain version at every stated shape; rtol
    1e-4, atol 1e-5 (tests/test_kernels.py:35: the same f32 terms summed in
    another order). Times at the yelp and book shapes."""
    import torch

    from consistent__style_transfer_torch.kernels.sinkhorn import (
        sinkhorn_pallas,
        sinkhorn_pallas_cr,
    )
    from consistent__style_transfer_torch.ops.emd import sinkhorn_ot_cost

    cases = [("yelp", 256, 27, 27, None, False), ("book", 128, 45, 45, None, False),
             ("ragged", 5, 9, 7, (7, 5), False), ("single", 1, 27, 27, None, False),
             ("zero_pairs", 6, 27, 27, None, False), ("interior_zeros", 64, 27, 27, None, True),
             ("cap_full", 4, 64, 64, (64, 64), False), ("b257", 257, 27, 27, None, True)]
    checks, worst = [], 0.0
    for seed, (name, B, N, M, lengths, scatter) in enumerate(cases):
        p, q, D = sinkhorn_inputs(B, N, M, seed, lengths, scatter)
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
    print(json.dumps({"sinkhorn_checks": checks}), flush=True)
    timed = {"max_abs_err": worst}
    for name, B, N, seed in (("yelp", 256, 27, 0), ("book", 128, 45, 1)):
        p, q, D = sinkhorn_inputs(B, N, N, seed)
        timed[name] = sinkhorn_times(p, q, D)
    print(json.dumps({"sinkhorn_times_synthetic": timed}), flush=True)
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

    breakdown = profile_breakdown(lambda: step(x, labels), watch=("ffn_", "vocab_argmax"))
    device_ms = breakdown.get("device_ms_per_batch")
    idle = (1 - device_ms / ms) if isinstance(device_ms, float) else "not measured"
    result = {"card": card, "dtype": "bfloat16", "V": YELP_V, "L": YELP_L, "B": YELP_B,
              "ms_per_batch": ms, "sent_per_s": YELP_B * 1e3 / ms,
              "launches_per_batch": launches / n, "device_idle_share": idle,
              "profile": breakdown}
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
    err = 0.0
    for entry in (sinkhorn_pallas, sinkhorn_pallas_cr):
        got = entry(p, q, D)
        err = max(err, (got - ref).abs().max().item())
        check(bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-5)),
              f"{entry.__name__} on a label batch: max abs err {err}")
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
    # the labeler's device time by part: the Sinkhorn, the host-to-device
    # copies, and the rest (the vector gathers and ot_inputs' ground cost)
    prof = profile_breakdown(lambda: labeler.label_pairs(nx1, nl1, nx2, nl2), batches=5,
                             watch=("sinkhorn", "Memcpy"))
    label_device = {"device_ms": prof.get("device_ms_per_batch", "not measured"),
                    "kernels": prof.get("kernels_per_batch", "not measured"),
                    "top": prof.get("top", "not measured")}
    if isinstance(label_device["device_ms"], float):
        part = {w: sum(r["ms_per_batch"] for r in prof["watched"] if w in r["name"])
                for w in ("sinkhorn", "Memcpy")}
        label_device.update(sinkhorn_ms=part["sinkhorn"], memcpy_ms=part["Memcpy"],
                            ot_inputs_and_rest_ms=label_device["device_ms"] - sum(part.values()))
    # valid atoms a side: the pair with the most sets the kernel's time
    n_on, m_on = (p > 0).sum(-1).float(), (q > 0).sum(-1).float()
    real = {"atoms": (p.shape[1], q.shape[1]), "pair_inputs_ms_host": pair_inputs_ms,
            "valid_atoms": {"mean": [n_on.mean().item(), m_on.mean().item()],
                            "max": [n_on.max().item(), m_on.max().item()],
                            "pairs_over_16": int(((n_on > 16) | (m_on > 16)).sum())},
            "label_pairs_ms_host": label_pairs_ms, "label_device": label_device,
            "max_abs_err": err, **sinkhorn_times(p, q, D)}

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
    card, build = phase_card_and_build()
    timed = phase_kernel_vs_plain()
    sinkhorn = phase_sinkhorn_vs_plain()
    with tempfile.TemporaryDirectory() as work:
        served = phase_serve_and_infer(work)
        full = phase_full_width(card)
        pre = phase_pretrain(work, card)

    yelp = timed[f"bfloat16_V{YELP_V}"]
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
        # graph-timed on a real yelp label batch (sinkhorn_times)
        "ms": real[f"{key}_ms"],
        "kernel_ms": real[f"{key}_ms"],
        "eager_ms": real[f"{key}_eager_ms"],
        "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"],
        "bound_by": real["bound_by"],
        "bound_term": real["bound_term"],
        "bound_share": real["bound_ms"] / real[f"{key}_ms"],
        "library_ms": None,  # no single PyTorch call computes a Sinkhorn
        "device_ops_per_call": real[f"{key}_device_ops_per_call"],  # graph nodes, exact
        "profiler_kernels_per_call": real[f"{key}_profiler_kernels_per_call"],
        "shape": {"B": real["B"], "N": real["atoms"][0], "M": real["atoms"][1],
                  "valid_terms_per_iter": real["valid_terms_per_iter"],
                  "valid_atoms": real["valid_atoms"], "dtype": "float32",
                  "inputs": "one yelp WMD-label batch"},
        "synthetic": {k: {f: v[f] for f in (f"{key}_ms", f"{key}_eager_ms", "bound_ms",
                                            "bound_term")}
                      for k, v in sinkhorn.items() if isinstance(v, dict)},
    } for name, line, key in (("sinkhorn_pallas", 178, "kernel"),
                              ("sinkhorn_pallas_cr", 129, "kernel_cr"))]
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
        # graph-timed, weights read from device memory (head_times)
        "ms": yelp["kernel_ms"],
        "kernel_ms": yelp["kernel_ms"],
        "plain_ms": yelp["plain_ms"],
        "bound_ms": yelp["bound_ms"],
        "bound_by": yelp["bound_by"],
        "bound_share": yelp["bound_share"],
        "library_ms": yelp["library_ms"],
        # the eager back-to-back timing, and the L2-warm graph timing
        "eager_ms": yelp["kernel_eager_ms"],
        "plain_eager_ms": yelp["plain_eager_ms"],
        "library_eager_ms": yelp["library_eager_ms"],
        "warm_ms": yelp["kernel_warm_ms"],
        "library_warm_ms": yelp["library_warm_ms"],
        "device_ops_per_call": yelp["kernel_device_ops_per_call"],
        "library_device_ops_per_call": yelp["library_device_ops_per_call"],
        "sass_hgmma": build["decode_step"]["sass_hgmma"],
        "shape": {"B": YELP_B, "Din": DIN, "H": HID, "V": YELP_V, "dtype": "bfloat16"},
        "other_shapes": {k: v for k, v in timed.items() if k != f"bfloat16_V{YELP_V}"},
    }, *sinkhorn_rows]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
