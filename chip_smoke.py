#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``consistent__style_transfer_torch``)
on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py        # from the root of a checkout; needs CUDA and nvcc

Phases, in order; any failure exits non-zero before the last line:
1. the card's name and power limit (nvidia-smi), the nvcc version, and
   the build of every
   kernel from the checkout's sources (``build/torch_kernels/``), one nvcc
   per source, all started together, with ptxas's registers, shared memory
   and spills per kernel and, where cuobjdump is installed, the count of
   HGMMA (wgmma) instructions in each library;
2. every kernel against its plain PyTorch version on the card, at the shapes
   its path gives it, with times and the bound: the decode head at the
   serving shapes (timed as CUDA graphs of 50 calls, so that a call of a few
   microseconds is not paced by the host, beside the eager back-to-back time,
   with its device operations per call as CUDA graph nodes, checked, and
   the profiler's count beside them), the Sinkhorn
   through both of its names at the yelp and book WMD-label shapes, a ragged
   shape, all-zero pairs, B=1, masks with interior zeros, the 64 x 64 cap
   and B=257, then graph-timed and eager at the yelp and book shapes with its
   device operations per call, the bound (bytes, FMA work, special
   functions) and its share; the fused LSTM cell at yelp's and book's
   encoder and decoder shapes in its three dtype pairs (the forward bit
   for bit against the plain equations, the backward against float64,
   one device operation a call), graph-timed beside the eager equations
   and PyTorch's fused cell, with its byte bound;
3. ``serve`` and ``infer`` through the port's CLI on the committed yelp test
   split (BPE trained on the yelp train split, fresh seeded weights saved as a
   checkpoint), each greedy batch one CUDA graph replay but the first, with
   the decode head's launch count (replayed launches included) and the
   graphs' replays read around each; and the card's greedy ids (a replay)
   held against the CPU's on a few sentences in float32, and the test
   split's lines too;
4. greedy transfer at the full yelp width (V=10000, L=18, B=256, bf16),
   graphed beside eager in this run: ms per batch, sentences/s, device ms,
   device operations, host launch calls, idle share, the graph's nodes,
   graphed ids against eager ones (equal in float32, at most
   BF16_TOKEN_SHARE of the tokens apart in bf16), and the decode head's
   profiled time a call inside the replay beside its graph-timed time;
5. ``w2v`` through the port's CLI (the native hogwild trainer, its 10
   epochs), then ``pretrain --epochs 1`` at the full yelp width
   (the three scorers at 6 layers / 8 heads / d=512, B=256, L=18, bf16
   autocast) on the committed yelp corpus: the
   checkpoints load strictly, every logged loss is finite, and the Sinkhorn
   kernel launched once per labeled batch; then the Sinkhorn on a real label
   batch (checked and timed as in phase 2, with the labeler's host
   times and its device time split into the Sinkhorn, the copies and the
   rest), ms per step, sentences/s, and a profiler breakdown; the epoch's
   steps replay one CUDA graph, and the steady step runs eager and graphed;
   float32 replays of two flag tuples, the second captured after a freeze
   with a save pending on the saver's thread, against as many eager steps
   from one saved state (dropout on); the epoch's validation a graph replay
   a dev batch but the first, and float32 validation passes of both flag
   tuples, graphed against eager, with equal losses;
6. the generator's training at full yelp width on phase 5's BPE dump and
   scorers: ``warmup`` through the CLI (one epoch, B=512, bf16 autocast,
   float32 parameters), ``optimize --epochs 1`` (B=256, the 6-layer / 8-head
   / d=512 frozen matcher and LM), and ``infer`` on the ``G_epoch_0.pth``
   it wrote (its steps replaying CUDA graphs of the fused step, one batch
   a group): the checkpoints load strictly, every logged loss is finite, one
   step a batch, D applied ceil(steps / d_update_every) times, the decode
   head launched 0 times in training and 18 a batch in the infer; the
   warmup epoch's and the infer's steps replay one CUDA graph each; then ms
   per step and sentences/s over each CLI epoch and over 20 steady steps of
   the same step function (warmup eager and graphed), device ms, idle share
   and the top device operations (profiler), kernels per step, and peak
   memory; float32 warmup replays against as many eager steps from one
   saved state (dropout on); the warmup's and the optimize epoch's
   validation graph replays, and float32 validation passes of both stages,
   graphed against eager, with equal losses;
7. the eval harness on phase 6's ``.tsf`` files: ``eval-prepare`` through
   the CLI (the fastText classifier fitted on the card, its epochs in
   chunks replayed as CUDA graphs, the lexicon and the adversarial LR with
   the C++ L1 solver, the masked word2vec with the native hogwild trainer;
   each substage's seconds, beside the numpy trainer's times), checked
   (the classifier loads, its ``fit_meta`` is the minibatch path at B=64
   with no retry, every chunk a graph replay but the first of its shape,
   dev P@1 at or above the JAX package's less a margin, the artifacts
   exist), then ``eval`` (STI, CP, NT, ACC, self-BLEU, ref-BLEU in range),
   its CP within a stated bound of the CP from a one-thread masked
   word2vec; the lexicon's and the adversarial LR's fits with the C++ and
   the Python solver on the same matrices (seconds, iterations, each fit
   meeting newGLMNET's stopping rule at its weights, the objectives beside
   a tightly converged fit's; for the lexicon the C++ objective at or below
   the Python one's x (1 + LR_OBJ_REL) and the lexicons at most
   LEXICON_WORDS_TOL words apart; the NT of each adversarial LR); the graphed fit
   equal to an eager fit on the card bit for bit and held against a CPU
   fit from the same seed; a minibatch epoch and the sequential path's
   epoch on 1,000 examples, graphed beside eager (host s, device ms,
   device operations, host launch calls, idle share; phase 11's ``run``
   drives the chain of stages);
8. the optimize stage with ``megastep_k=8`` (its fused step as CUDA graphs,
   one per D-apply branch, as in every optimize run on the card) at full
   yelp width on phases 5-6's dumps: graph replays held against eager
   ``fused_step`` from one state in float32 and bf16 (dropout off, coins
   given), and in float32 with dropout on and the coins drawn, both runs
   starting from the same saved generator states; ``optimize --epochs 1
   --megastep_k 8 --resume 1`` through the CLI (finite losses, one step a
   batch, D's cadence, the full state written); the graphed step's steady
   ms per step, device ms, device operations, host launch calls and graph
   replays per step, idle share and peak memory beside phase 6's eager
   step; the CLI epoch's validation a graph replay a dev batch but the
   first; and ``infer`` from the G it keeps, through the decode head;
9. beam decode and the transformer backbone: the LSTM's stateful beam
   (K=4) at the yelp serving shape, a CUDA graph replay, beside the eager
   beam and greedy on the same batch (ms per batch, sentences/s, device ms,
   idle share; bf16 graphed ids at most BF16_TOKEN_SHARE apart from
   eager), its float32 ids and scores on the card against the CPU's, and
   graphed against eager at the full batch (equal), ``serve`` and ``infer`` with
   ``--beam_size 4`` through the CLI on phase 6's G; then the transformer
   (T5-small widths, float32 compute), through the CLI on the first
   CUT_LINES lines of each yelp split file: ``warmup --backbone
   transformer`` (one epoch, B=512), ``optimize
   --backbone transformer --epochs 1`` (B=256, the graphed step),
   ``infer`` greedy through the CLI and the beam of 4 on the test split
   (checkpoints load strictly, finite losses, one step a batch, D's
   cadence; the warmup epoch's and the greedy infer's steps replaying one
   graph each), graph replays of the optimize and warmup steps against
   eager steps in float32 from one saved state, the steady warmup and
   optimize steps (eager and graphed: ms, device ms, device operations,
   idle share, peak memory), greedy and beam-4 rates on a batch (graphed
   and eager; the float32 beam's graphed ids and scores equal to eager),
   and the card's ids against the CPU's. The decode head launches 0 times
   in the beam and transformer paths;
10. data parallelism (``parallel/``) at world size 1, the one card: in
   this process a world-size-1 NCCL group, the graphed optimize steps at
   full yelp width with the group's all-reduces captured held bit for bit
   against the same steps without a group (dropout off and coins given;
   dropout on and coins drawn), with the graphs' node counts, and the same
   for warmup and pretrain steps; the graphed step's steady time with and
   without the group; then ``pretrain``, ``warmup``, ``optimize`` and
   ``infer`` through ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m consistent__style_transfer_torch`` in a fresh dump
   dir, on the first CUT_LINES lines of each yelp split file: finite
   losses, one step a batch, the child's own kernel launch counts
   (``TPUST_KERNEL_COUNTS=1``), and its ``.tsf`` files byte-equal to a
   plain ``infer``'s;
11. the full yelp pipeline, the JAX package's 16k smoke recipe
   (``RESULTS.md:1103-1110``), in a fresh dump dir: ``pretrain`` (10
   epochs), ``warmup --warmup_epochs 10`` and ``run`` (optimize, 10 epochs;
   ``infer``; ``eval-prepare``; ``eval``) at full width, bf16, seed 0: the
   epochs each stage ran, its epoch and validation seconds, every train
   step and dev batch a graph replay but the first of each branch, the
   Sinkhorn once a labeled batch and the decode head 18 times an infer
   batch, the prepare timings, ``adv_lr_s`` split into reading, the
   transform and the C++ fit with its iterations, the saved LR held to
   newGLMNET's stopping rule on its matrix, the results file's lines (STI,
   CP, NT),
   the three validation passes on the trained
   weights graphed against eager, and the six scores, each held to a band
   around the JAX package's default-RNG row (``RESULTS.md:315``;
   ``FULL_RUN_BAND``), the threefry rows printed beside them;
12. the book dataset (L=30, B=128, warmup B=512, no human references) on
   the first BOOK_CUT_LINES lines of each ``data/book`` split file, at
   book's full widths, in a fresh dump dir: ``vocab``, ``w2v``,
   ``pretrain --epochs 1``, ``warmup``, ``run --epochs 1`` and ``serve``
   through the CLI (strict checkpoints, finite losses, one step a batch,
   D's cadence, every step, dev batch and infer batch a graph replay but
   the first of each branch, the Sinkhorn once a labeled batch on its
   45-atom path, the decode head 30 times an infer batch, the eval
   classifier's epochs as graph replays, ``eval``'s scores in range and no
   ref-BLEU line; eval-prepare's classifier, lexicon and adversarial-LR
   seconds beside BOOK_PREPARE_BEFORE_S, the adversarial LR held to the
   stopping rule); the Sinkhorn on a real book
   label batch against its plain version and the collate's host ms a
   batch; the graphed steps' ms, device ms, idle share and peak memory;
   float32 replays of the three steps and validation passes against eager;
   serving at B=128, the card's float32 greedy ids against the CPU's and
   the float32 beam of 4 graphed against eager; the decode head at B=128
   and book's V against its plain version, timed beside the library call.
Every path from phase 3 on also zeroes and reads the fused LSTM cell's
forward and backward launches and checks them: 3 x L forward a greedy or
beam batch, 3 x L forward and backward a warmup step, the optimize step's
count (``fused_step_cells``) in every graph it replays, none in pretrain,
eval and the transformer.
Then one JSON line of kernel numbers and, last, the device line.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
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
KERNEL_SOURCES = ("decode_step", "sinkhorn", "lstm_cell")
SINKHORN_EPS, SINKHORN_ITERS = 0.05, 100
# phase 2: the fused LSTM cell's shapes (B, H) on the main path, yelp's and
# book's encoder and decoder, each in the kernel's three dtype pairs (gates /
# cell state); its backward against float64 autograd through the reference,
# as a relative norm: within 2e-2 where bf16 is involved (autograd's chain
# rounds to bf16 after each op, at 2^-9 each; the kernel once, at the end)
# and 1e-5 in float32 (the same f32 arithmetic in another order), the bounds
# tests/test_torch_lstm_cell_cuda.py states
LSTM_SHAPES = {"yelp_encoder": (256, 256), "yelp_decoder": (256, 512),
               "book_encoder": (128, 256), "book_decoder": (128, 512)}
LSTM_PAIRS = {"bf16_f32": ("bfloat16", "float32"), "bf16_bf16": ("bfloat16", "bfloat16"),
              "f32_f32": ("float32", "float32")}
LSTM_BWD_TOL = {"bf16": 2e-2, "float32": 1e-5}
# phase 7: dev P@1 of the JAX package's own fastText fit on the committed
# yelp split (on the CPU, seed 0; tests/test_torch_eval_fasttext.py measures
# it), less a margin of 0.005 (20 of the 4,000 dev sentences)
EVAL_P1_JAX_CPU, EVAL_P1_MARGIN = 0.99925, 0.005
EVAL_P1_FLOOR = EVAL_P1_JAX_CPU - EVAL_P1_MARGIN
# the card's fit against the CPU's from one seed (index_add_ on the card sums
# repeated rows in no fixed order): dev P@1 within 10 of 4,000 sentences,
# each table entry (up to about 3.3) within 1e-3
FASTTEXT_P1_TOL, FASTTEXT_TABLE_TOL = 0.0025, 1e-3
# phase 7: the CP of the hogwild masked word2vec (the default threads) against
# the one-thread trainer's, relative: the bound tests/test_torch_native.py
# states; and the numpy trainer's times on the card's host as PERF.md §5
# records them (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
CP_REL_TOL = 0.10
NUMPY_TRAINER_S = {"mask_w2v_s": (102.89, 146.34), "eval_prepare_s": (109.64, 156.46)}
# phases 7 and 11: the C++ L1 LR (what eval-prepare runs) against the Python
# solver on the same matrix. Each fit meets newGLMNET's stopping rule at the
# weights it returns (L1LogisticRegression.stopping_violation, recomputed
# from the weights: within STOP_SLACK of the bound for the rounding of a
# fresh exp(X.w)) below the Newton cap. The lexicon fit (the committed
# yelp train) is also held to the bounds tests/test_torch_eval_lexicon.py
# holds the port to against liblinear: the C++ objective at or below the
# Python one's x (1 + LR_OBJ_REL), the lexicons at most LEXICON_WORDS_TOL
# words apart. The adversarial fits are near-separable (one-epoch transfers
# such as "i is and and and ."): there the stopping rule leaves a fit
# anywhere from 4.3e-4 to 1.51e-3 above the minimum whatever the solver (on
# the NVIDIA H100 80GB HBM3's host), and liblinear's own fits under three
# seeds spread 1.3e-4 on tests/test_torch_l1r_lr.py's near-separable
# problem, so their objectives are printed beside a fit converged 1,000
# times tighter (TIGHT_EPS), not held to each other
LR_OBJ_REL, LEXICON_WORDS_TOL, STOP_SLACK, TIGHT_EPS = 5e-5, 3, 1e-6, 1e-3
# phase 12: book's eval-prepare substages with the Python solver and the
# fastText epochs launched op by op, on the card's host (PERF.md §5: two runs,
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
BOOK_PREPARE_BEFORE_S = {"classifier_s": (1.62, 1.49), "lexicon_s": (5.69, 5.41),
                         "adv_lr_s": (2.61, 1.99)}
# phase 8: graph replays against eager fused_step from one state (9 steps,
# D every 4th: each branch replayed at least twice), with dropout off and
# the coins given, and in float32 with dropout on and the coins drawn from
# the same saved generator states. Per-step losses within a relative bound;
# the parameters' mean absolute difference within a share of their mean
# absolute move (a gradient entry near 0 summed by atomics in another order
# can flip the sign of its Adam step, so the largest entry is printed, not
# bounded). float32 is the strict check. Under bf16 autocast a product
# summed in another order (cuBLAS may pick another kernel on the capture
# stream) moves an output by one bf16 step, 0.4%, and can flip an argmax of
# the straight-through decode: measured on an NVIDIA H100 80GB HBM3 at
# 700 W, losses 0.16-0.5% apart and parameters 0.29-0.35% of their move; the
# bf16 bounds are about 3x those
GRAPH_TOL = {"float32": {"loss_rel": 1e-5, "param_share": 1e-3},
             "bfloat16": {"loss_rel": 1.5e-2, "param_share": 1e-2}}
MEGASTEP_K = 8
# phase 9: the beam width and a check of the card's float32 beam against the
# CPU's on a few sentences: ids equal, normalised scores (sums of 18 float32
# log-probs over 18 ** 0.6) within an absolute bound; graph
# replays of the transformer's fused step against eager ones over this many
# steps after the two captures (D applies at the first and the fifth)
BEAM_K, BEAM_CHECK_N, BEAM_SCORE_TOL = 4, 4, 1e-4
TF_REPLAY_STEPS = 5
# phases 9 and 10: the transformer's CLI commands and the launcher's run on
# the first lines of each yelp split file, a style (a cut of depth): 2,000 of
# 16,000 train, 500 of 2,000 dev, all 500 test
CUT_LINES = {"train": 2000, "dev": 500, "test": None}
# phase 12: the book corpus (data/book: 40,000 train, 5,000 dev and 5,000
# test lines a style, no human references) cut to its first lines of each
# split file, a style (a cut of depth; every width is book's own). 24,000
# train sentences keep eval-prepare's classifier on the minibatch path, as
# the whole corpus takes it (the sequential path below 20,001 examples)
BOOK_CUT_LINES = {"train": 12000, "dev": 1000, "test": 1000}
# phase 12: book test lines sent to serve (3 batches of B=128, the last
# padded) and sentences in the float32 card-against-CPU id check
BOOK_SERVE_LINES, BOOK_CHECK_N = 300, 16
# phases 4 and 9: graphed greedy ids against eager ones under bf16: at most
# this share of tokens may differ (a product summed in another order, should
# cuBLAS pick another kernel on the capture stream, moves a logit by a bf16
# step and can flip a near-tied argmax; a flipped token changes the rest of
# its row); float32 is held exactly
BF16_TOKEN_SHARE = 0.01
# phases 5, 6 and 9: replays of the pretrain and warmup steps against as
# many eager steps from one saved state, float32, dropout on
STEP_REPLAYS = 6
# phases 5, 6, 9 and 11: each validation pass, graphed and eager, this many
# times over the same dev batches
VAL_PASSES = 3
# phase 11: the JAX package's 16k yelp smoke (RESULTS.md:1103-1110: vocab,
# w2v, pretrain, warmup --warmup_epochs 10, then run, which chains optimize
# (10 epochs), infer, eval-prepare and eval), held to the JAX package's scores
# on that recipe under its default RNG (rng_impl="rbg",
# consistent__style_transfer_tpu/config.py:75): RESULTS.md:315
FULL_RUN_WARMUP_EPOCHS, FULL_RUN_VER = 10, "v_full"
FULL_RUN_JAX = {"STI": 0.996, "CP": 0.282, "NT": 0.159, "ACC": 0.979, "selfBLEU": 20.3,
                "refBLEU": 9.59}
# the band's half-widths, from the JAX package's own run-to-run spread on this
# recipe: the two threefry 16k runs (RESULTS.md:314 against :516) moved STI
# 0.008, CP 0.001, NT 0.013, self-BLEU 0.4; float32 against bf16 cp_base
# (:516 against :639-641) STI 0.016, NT 0.009; the 270k threefry/rbg pair
# that RESULTS.md calls noise (:313 against :312) NT 0.042, self-BLEU 1.7,
# ref-BLEU 0.91. NT, the noisiest score, gets twice its largest spread
# (the port gave 0.130-0.228 over seeds 0 and 1 on an NVIDIA H100 80GB HBM3
# at 700.00 W)
FULL_RUN_BAND = {"STI": 0.03, "ACC": 0.03, "CP": 0.03, "NT": 0.08, "selfBLEU": 2.5,
                 "refBLEU": 1.0}
# printed beside the scores, unchecked: the same recipe's rows from before
# rbg became the JAX package's default
FULL_RUN_THREEFRY = {
    "RESULTS.md:314 (16k smoke, threefry)": {"STI": 0.976, "CP": 0.514, "NT": 0.149,
                                             "ACC": 0.971, "selfBLEU": 9.5},
    "RESULTS.md:516 (cp_base, threefry, warmup 40, float32)": {
        "STI": 0.984, "CP": 0.515, "NT": 0.136, "ACC": 0.973, "selfBLEU": 9.9}}
# the host's CUDA runtime calls that put work on the card, as the profiler
# names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def laps(phase: str):
    """A function ``lap(what)`` that logs the seconds since its last call
    (the first call: since ``laps`` was called) as ``phase: what``."""
    last = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"{phase}: {what} in {now - last[0]:.1f} s")
        last[0] = now

    return lap


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

    from consistent__style_transfer_torch.train.graphs import gc_paused

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
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
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    log(nvcc[-1] if nvcc else "nvcc --version printed nothing")
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
    print(json.dumps({"build": report, "build_wall_s": round(wall, 3),
                      "nvcc": nvcc[-1] if nvcc else None}), flush=True)
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
    operations per call are the nodes of a CUDA graph of one call (exact),
    with the profiler's count beside them (it can drop events: it once gave
    0.6 a call for the kernel's 2)."""
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
        out[f"{key}_device_ops_per_call"] = graph_nodes_per_call(lambda: fn(x, w1, b1, w2))
        for _ in range(3):  # the tracer now and then returns no device events
            prof = profile_breakdown(lambda: fn(x, w1, b1, w2), batches=10)
            if "kernels_per_batch" in prof:
                break
        out[f"{key}_profiler_kernels_per_call"] = prof.get("kernels_per_batch", "not measured")
        if key == "kernel":
            out["kernel_profile"] = prof.get("top", "not measured")
    out["bound_share"] = bound_ms / out["kernel_ms"]
    return out


def check_head(x, w1, b1, w2, dtype_name: str) -> dict:
    """The kernel against its plain version on one input: in float32 the
    same sums in another order (ids exact, h within 1e-4); in bf16 h within
    2e-2 of the plain bf16 h relative to its size and within 1e-4 of f32
    math on the same rounded inputs, and a differing id a near-tie (1e-2)
    of the f32 logits."""
    import torch

    from consistent__style_transfer_torch.kernels.decode_step import (
        decode_head_reference,
        fused_decode_logits,
    )

    B, V = x.shape[0], w2.shape[0]
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
        check(mismatch.numel() == 0, f"f32 ids differ at rows {mismatch.tolist()[:8]}")
        check(err_h <= 1e-4, f"f32 h differs by {err_h}")
    else:
        scale = ref_h.float().abs().max().item()
        check(err_h <= 2e-2 * scale, f"bf16 h differs by {err_h} (|h| max {scale})")
        check(err_h32 <= 1e-4, f"bf16-input h differs from f32 math by {err_h32}")
        if mismatch.numel():
            rows = mismatch
            gap = (logits32[rows].max(-1).values - logits32[rows, ids[rows].long()]).max().item()
            row["max_logit_gap"] = gap
            check(gap <= 1e-2, f"bf16 id off the f32 max by {gap}")
    return row


def phase_kernel_vs_plain() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain version in full f32
    checks, timed = [], {}
    shapes = [(YELP_B, YELP_V), (YELP_B, 5317), (1, YELP_V), (200, YELP_V)]
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for seed, (B, V) in enumerate(shapes):
            x, w1, b1, w2 = head_inputs(B, V, dtype, seed)
            row = check_head(x, w1, b1, w2, dtype_name)
            checks.append(row)
            if B == YELP_B and V in (YELP_V, 5317):
                timed[f"{dtype_name}_V{V}"] = head_times(x, w1, b1, w2, dtype_name, seed)
                timed[f"{dtype_name}_V{V}"].update(max_abs_err_h=row["max_abs_err_h"],
                                                    ids_mismatch=row["ids_mismatch"])
    print(json.dumps({"kernel_checks": checks}), flush=True)
    print(json.dumps({"decode_head_times": timed}), flush=True)
    for name, t in timed.items():
        check(t["kernel_device_ops_per_call"] == 2,
              f"decode head {name}: {t['kernel_device_ops_per_call']} device operations "
              "(graph nodes) per call, want 2")
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
    import torch

    from consistent__style_transfer_torch.train.graphs import gc_paused

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with gc_paused(), torch.cuda.graph(graph):
        fn()
    return graph_nodes(graph)


def graph_nodes(graph) -> int:
    """The nodes of a captured CUDA graph (``keep_graph=True``), counted by
    libcuda's cuGraphGetNodes (``utils/profiling.py::graph_nodes``)."""
    from consistent__style_transfer_torch.utils.profiling import graph_nodes as count

    n = count(graph)
    check(n is not None, "cuGraphGetNodes failed")
    return n


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


def lstm_cell_inputs(B: int, H: int, gates, state, seed: int) -> list:
    """a, b (B, 4H) in the gates' dtype over the activations' whole range (a
    few saturated), c, dh and dc_new (B, H) in the cell state's, made on the
    CPU from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(B, 4 * H, generator=g) * 2 for _ in range(2))
    c = torch.randn(B, H, generator=g) * 2
    dh, dcn = (torch.randn(B, H, generator=g) for _ in range(2))
    return [t.to("cuda", gates) for t in (a, b)] + [t.to("cuda", state) for t in (c, dh, dcn)]


def lstm_cell_grads(fn, a, b, c, dh, dcn, dtype=None) -> tuple:
    """(da, db, dc) of the cell ``fn`` at (a, b, c) for the output
    gradients (dh, dcn), through autograd, the inputs in ``dtype`` if given."""
    import torch

    leaves = [t.detach().to(dtype or t.dtype).requires_grad_() for t in (a, b, c)]
    h, c_new = fn(*leaves)
    return torch.autograd.grad((h, c_new), leaves, (dh.to(h.dtype), dcn.to(c_new.dtype)))


def lstm_cell_bound(B: int, H: int, gates, state) -> dict:
    """Bytes each kernel must move and their time at the HBM rate: the
    forward reads a, b and c and writes h, c_new and the gate sum; the
    backward reads the gate sum, c, c_new, dh and dc_new and writes dgates
    and dc. A few f32 operations and three special functions an element lie
    far below the card's rates, so bytes bound both."""
    g, s = gates.itemsize, state.itemsize
    fwd = 3 * B * 4 * H * g + 3 * B * H * s
    bwd = 2 * B * 4 * H * g + 5 * B * H * s
    return {"fwd_bytes": fwd, "bwd_bytes": bwd, "bound_fwd_ms": fwd / PEAK_BYTES_S * 1e3,
            "bound_bwd_ms": bwd / PEAK_BYTES_S * 1e3,
            "bound_ms": (fwd + bwd) / PEAK_BYTES_S * 1e3, "bound_by": "bytes"}


def lstm_library_times(a, b, c, dh, dcn, h_ref) -> dict:
    """PyTorch's own fused cell, ``torch.ops.aten._thnn_fused_lstm_cell`` (what
    ``nn.LSTMCell`` runs on CUDA) and its ``_backward_impl``, graph-timed
    beside the kernel, with its h against the reference's; or, where the op
    refuses these inputs or is absent, the error it raised."""
    import torch

    try:
        fwd_op = torch.ops.aten._thnn_fused_lstm_cell
        bwd_op = torch.ops.aten._thnn_fused_lstm_cell_backward_impl
        h, cy, work = fwd_op(a, b, c)
        bwd_op(dh, dcn, c, cy, work, False)
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError) as e:
        return {"library": "torch.ops.aten._thnn_fused_lstm_cell",
                "library_error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"}
    return {"library": "torch.ops.aten._thnn_fused_lstm_cell",
            "library_fwd_ms": graph_ms(lambda: fwd_op(a, b, c)),
            "library_bwd_ms": graph_ms(lambda: bwd_op(dh, dcn, c, cy, work, False)),
            "library_h_max_abs_diff": (h.double() - h_ref.double()).abs().max().item(),
            "library_h_equal": bool(torch.equal(h, h_ref))}


def phase_lstm_cell_vs_plain() -> dict:
    """The fused LSTM cell (``kernels/lstm_cell.py``, ``csrc/lstm_cell.cu``)
    against its plain version at the main path's shapes, yelp's and book's
    encoder (H=256) and decoder (H=512), each in the three dtype pairs:
    the forward bit for bit against ``lstm_cell_reference`` under bf16
    autocast, with and without the saved gate sum; the backward's dgates
    (one tensor for a and b) and dc against float64 autograd through the
    reference (LSTM_BWD_TOL, and for the bf16 pairs no farther than eager's
    own chain); one device operation a kernel call; graph-timed forward
    and backward, the eager equations (forward, and with autograd's
    backward) and PyTorch's fused cell beside them, and the byte bound."""
    import torch

    from consistent__style_transfer_torch.kernels import lstm_cell as lc

    def rel(x, ref):
        return ((x.double() - ref).norm() / ref.norm()).item()

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    out = {}
    for seed, (shape, (B, H)) in enumerate(LSTM_SHAPES.items()):
        for pair, (gname, sname) in LSTM_PAIRS.items():
            gates, state = dtypes[gname], dtypes[sname]
            a, b, c, dh, dcn = lstm_cell_inputs(B, H, gates, state, 100 * seed + len(out))
            what = f"{shape}/{pair}"
            with torch.autocast("cuda", dtype=torch.bfloat16):
                with torch.no_grad():
                    h0, c0 = lc.lstm_cell(a, b, c)
                h1, c1, kept = lc.lstm_cell_fwd(a, b, c, keep_gates=True)
                h_ref, c_ref = lc.lstm_cell_reference(a, b, c)
            torch.cuda.synchronize()
            check(h1.dtype == h_ref.dtype and c1.dtype == c_ref.dtype,
                  f"LSTM cell {what}: dtypes {h1.dtype}, {c1.dtype}")
            check(all(torch.equal(x, y) for x, y in ((h0, h_ref), (c0, c_ref), (h1, h_ref),
                                                   (c1, c_ref), (kept, a + b))),
                  f"LSTM cell {what}: the forward differs from the reference")
            da, db, dc = lstm_cell_grads(lc.lstm_cell, a, b, c, dh, dcn)
            ea, _, ec = lstm_cell_grads(lc.lstm_cell_reference, a, b, c, dh, dcn)
            ra, _, rc = lstm_cell_grads(lc.lstm_cell_reference, a, b, c, dh, dcn, torch.float64)
            check(torch.equal(da, db) and da.dtype == gates and dc.dtype == state,
                  f"LSTM cell {what}: dgates for a and b differ, or their dtypes")
            low = torch.bfloat16 in (gates, state)
            tol = LSTM_BWD_TOL["bf16" if low else "float32"]
            row = {"B": B, "H": H, "gates": gname, "cell_state": sname,
                   "forward_bit_identical": True, "bwd_tol": tol,
                   "dgates_rel_f64": rel(da, ra), "dc_rel_f64": rel(dc, rc),
                   "eager_dgates_rel_f64": rel(ea, ra), "eager_dc_rel_f64": rel(ec, rc)}
            check(row["dgates_rel_f64"] <= tol and row["dc_rel_f64"] <= tol,
                  f"LSTM cell {what}: backward off float64 by {row}")
            if low:
                check(row["dgates_rel_f64"] <= row["eager_dgates_rel_f64"]
                      and row["dc_rel_f64"] <= row["eager_dc_rel_f64"],
                      f"LSTM cell {what}: backward farther from float64 than eager's: {row}")

            def fwd(a=a, b=b, c=c):
                return lc.lstm_cell_fwd(a, b, c, keep_gates=True)

            def bwd(kept=kept, c=c, c1=c1, dh=dh, dcn=dcn):
                return lc.lstm_cell_bwd(kept, c, c1, dh, dcn, True, True)

            row["device_ops_per_call"] = {"forward": graph_nodes_per_call(fwd),
                                          "backward": graph_nodes_per_call(bwd)}
            check(row["device_ops_per_call"] == {"forward": 1, "backward": 1},
                  f"LSTM cell {what}: device operations a call {row['device_ops_per_call']}")
            row.update(
                fwd_ms=graph_ms(fwd), bwd_ms=graph_ms(bwd),
                fwd_bwd_autograd_ms=graph_ms(lambda: lstm_cell_grads(lc.lstm_cell, a, b, c, dh,
                                                                     dcn)),
                plain_fwd_ms=graph_ms(lambda: lc.lstm_cell_reference(a, b, c)),
                plain_ms=graph_ms(lambda: lstm_cell_grads(lc.lstm_cell_reference, a, b, c, dh,
                                                          dcn)),
                **lstm_cell_bound(B, H, gates, state),
                **lstm_library_times(a, b, c, dh, dcn, h_ref))
            row["ms"] = row["fwd_ms"] + row["bwd_ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            out[what] = row
    print(json.dumps({"lstm_cell_times": out}), flush=True)
    return out


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


@contextlib.contextmanager
def watch_graphs(module=None, name: str = "GraphedStep"):
    """The instances of ``module.name`` made inside the block: by default
    the ``GraphedStep``\\ s (``train/graphs.py``) that the stages make
    through ``step_runner``; ``train/optimize.py``'s ``GraphedFusedStep``
    is the optimize stage's train step. A list, filled as they are made, to
    read their graphs and replays from."""
    if module is None:
        from consistent__style_transfer_torch.train import graphs as module

    made, real = [], getattr(module, name)

    class Watched(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    setattr(module, name, Watched)
    try:
        yield made
    finally:
        setattr(module, name, real)


# the fused LSTM cell's launches each path made, as lstm_launches read them,
# for the kernels line
LSTM_LAUNCHES: dict[str, dict] = {}


def zero_lstm_launches() -> None:
    """Zero the fused LSTM cell's launch counters (forward and backward)."""
    from consistent__style_transfer_torch.kernels.lstm_cell import lstm_cell_bwd, lstm_cell_fwd

    lstm_cell_fwd.launches = lstm_cell_bwd.launches = 0


def lstm_launches(what: str, fwd: int | None, bwd: int | None = 0, counts=None,
                  keep: bool = True) -> dict:
    """The fused LSTM cell's forward and backward launches (replays included)
    since :func:`zero_lstm_launches`, or ``counts`` = (forward, backward)
    read elsewhere: each equal to ``fwd`` / ``bwd`` where that is a number,
    above 0 where it is None; kept in LSTM_LAUNCHES under ``what`` unless
    ``keep`` is false (a total of paths kept under their own names)."""
    from consistent__style_transfer_torch.kernels.lstm_cell import lstm_cell_bwd, lstm_cell_fwd

    if counts is None:
        counts = (lstm_cell_fwd.launches, lstm_cell_bwd.launches)
    got = {"forward": counts[0], "backward": counts[1]}
    for (name, n), want in zip(got.items(), (fwd, bwd)):
        check(n > 0 if want is None else n == want,
              f"{what}: {n} LSTM cell {name} launches, want {'some' if want is None else want}")
    if keep:
        LSTM_LAUNCHES[what] = got
    return got


def greedy_cells(head_launches: int) -> int:
    """The fused cell's forward launches of greedy decodes that launched the
    decode head ``head_launches`` times: one decoder cell beside each head
    call, and the encoder's two directions over the max_len input
    positions, as many as the decode steps."""
    return 3 * head_launches


def fused_step_cells(cfg) -> tuple[int, int]:
    """The fused cell's (forward, backward) launches in one optimize step of
    an LSTM ``cfg`` (``train/optimize.py::fused_step``), of either branch:
    each decode runs 3 x max_len cells (the encoder both ways, the decoder);
    G's straight-through decode and the back-translation decode (and the
    reconstruction decode where ``w_rec`` > 0) take a backward, D's fresh
    no-grad decode (unless ``fuse_gan_steps``) does not."""
    with_grad = 2 + (cfg.w_rec > 0)
    cells = 3 * cfg.max_len
    return cells * (with_grad + (not cfg.fuse_gan_steps)), cells * with_grad


@contextlib.contextmanager
def launches_inside(module, names: tuple):
    """The decode head's, the Sinkhorn's and the fused LSTM cell's launches
    made inside the calls of ``module.<name>``, for each of ``names``
    (``run`` calls ``train/optimize.py``'s ``run_optimize`` and then
    ``run_test``): a dict {name: {"head": n, "sinkhorn": n, "lstm_fwd": n,
    "lstm_bwd": n}}, filled as the calls return."""
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.lstm_cell import lstm_cell_bwd, lstm_cell_fwd
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda

    counters = {"head": fused_decode_logits, "sinkhorn": sinkhorn_cuda, "lstm_fwd": lstm_cell_fwd,
                "lstm_bwd": lstm_cell_bwd}
    seen = {n: dict.fromkeys(counters, 0) for n in names}
    real = {n: getattr(module, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            before = {c: k.launches for c, k in counters.items()}
            try:
                return real[name](*args, **kw)
            finally:
                for c, k in counters.items():
                    seen[name][c] += k.launches - before[c]
        return call

    for n in names:
        setattr(module, n, counted(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(module, n, real[n])


def check_replayed(made: list, keys: list, calls: int, what: str, steps: int = 1,
                   index: int = 0) -> dict:
    """``steps`` GraphedSteps were made; the one at ``index`` (a stage makes
    its train step's first, then its eval step's) has the graphs of
    ``keys`` and replayed every call but the first of each branch."""
    check(len(made) == steps, f"{what}: {len(made)} graphed steps, want {steps}")
    got = sorted(made[index].graphs, key=str)
    check(got == sorted(keys, key=str), f"{what}: graphs of {got}, want {keys}")
    want = calls - len(keys)
    check(made[index].replays == want, f"{what}: {made[index].replays} replays, want {want}")
    return {"graphs": [str(k) for k in got], "replays": made[index].replays, "calls": calls}


def validation_passes(cfg, stage: str, device, passes: int = VAL_PASSES) -> dict:
    """The validation of ``stage`` (pretrain, warmup or optimize) over
    ``cfg``'s dev split, through ``train/loop.py::validate`` with the stage's
    eval step in ``cfg.dtype`` on the weights in ``cfg``'s dump dir: a
    ``GraphedStep`` of the step (its first call captures, every later call
    replays) against the eager step, ``passes`` passes each over the same dev
    batches (collated once, so pretrain's WMD labels are made once). Per
    branch: every pass's losses, whether they are equal, ms per pass on the
    host clock, and the profiler's device ms, device operations, host calls
    and idle share of one pass each way. Pretrain runs every tower, then the
    matcher frozen, its inputs left out (a second graph)."""
    import torch

    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.models.generator import sched_coins
    from consistent__style_transfer_torch.train.common import (build_classifier, build_generator,
                                                               build_lm, build_matcher,
                                                               compute_dtype, get_corpus,
                                                               get_tokenizer, get_w2v)
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.loop import validate
    from consistent__style_transfer_torch.train.optimize import (VAL_INPUTS, OptimizeModels,
                                                                 load_frozen,
                                                                 load_generator_params,
                                                                 make_optimize_steps)
    from consistent__style_transfer_torch.train.pretrain import make_pretrain_steps, step_inputs
    from consistent__style_transfer_torch.train.state import AdamWithClip
    from consistent__style_transfer_torch.train.warmup import (EVAL_INPUTS, EVAL_SEED_OFFSET,
                                                               make_warmup_steps,
                                                               warmup_ckpt_name)

    tokenizer = get_tokenizer(cfg)
    V, L, dtype = len(tokenizer), cfg.max_len, compute_dtype(cfg)
    dev = get_corpus(cfg, "dev", tokenizer)
    if stage == "pretrain":
        labeler = SinkhornWmdLabeler(get_w2v(cfg, tokenizer), tokenizer,
                                     max_atoms=L + L // 2, device=device)
        batches = list(make_batches(dev, cfg.batch_size, L, "pretrain", shuffle=False,
                                    seed=cfg.seed, wmd_labeler=labeler))
        towers = {"cls": build_classifier(cfg, V, device), "mat": build_matcher(cfg, V, device),
                  "dn": build_lm(cfg, V, device)}
        for t, m in towers.items():
            m.load_state_dict(torch.load(os.path.join(cfg.ds_dump_dir, "pretrain", f"{t}.pth"),
                                         map_location=device, weights_only=True), strict=True)
        _, eval_step = make_pretrain_steps(towers, AdamWithClip(
            [p for m in towers.values() for p in m.parameters()], cfg.pretrain_lr,
            cfg.pretrain_clip), autocast_dtype=None if dtype == torch.float32 else dtype)

        def fn(inputs, flags):
            return list(eval_step(inputs, flags).values())

        branches = [(f, dict(shard=False, key=f, inputs=(*step_inputs(f), "row_mask")))
                    for f in ((True, True, True), (True, False, True))]
    elif stage == "warmup":
        batches = list(make_batches(dev, cfg.warmup_batch_size, L, "warmup", shuffle=False,
                                    seed=cfg.seed))
        model = build_generator(cfg, V, device, training=True)
        model.load_state_dict(torch.load(os.path.join(cfg.ds_dump_dir, "warmup",
                                                      warmup_ckpt_name(cfg)),
                                         map_location=device, weights_only=True), strict=True)
        _, eval_step = make_warmup_steps(model, AdamWithClip(model.parameters(), cfg.warmup_lr,
                                                             cfg.warmup_clip), dtype)
        coins = sched_coins(L, torch.Generator(device).manual_seed(cfg.seed + EVAL_SEED_OFFSET),
                            device)

        def fn(inputs, _):
            return [eval_step(inputs, inputs["coins"])]

        branches = [(None, dict(inputs=EVAL_INPUTS, static={"coins": coins}))]
    else:
        batches = list(make_batches(dev, cfg.batch_size, L, "optimize", shuffle=False,
                                    seed=cfg.seed))
        models = OptimizeModels(cfg, V, device)
        load_frozen(cfg, models)
        load_generator_params(cfg, models.generator)
        steps = make_optimize_steps(
            cfg, models, AdamWithClip(models.generator.parameters(), cfg.optimize_lr, 1.0),
            AdamWithClip(models.disc.parameters(), cfg.optimize_lr, 1.0))

        def fn(inputs, _):
            return [steps.val_step(inputs)]

        branches = [(None, dict(inputs=VAL_INPUTS))]

    graphed = GraphedStep(fn)
    out = {"stage": stage, "backbone": cfg.backbone, "dtype": cfg.dtype, "batches": len(batches),
           "passes": passes, "branches": {}}
    for key, kw in branches:
        def run(runner):
            return validate(batches, runner, device, **kw)  # noqa: B023

        run(graphed)  # the eager first call and the capture, then replays
        rows, losses = {}, {}
        for name, runner in (("eager", fn), ("graphed", graphed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[name] = [run(runner) for _ in range(passes)]  # each ends in a read
            ms = (time.perf_counter() - t0) * 1e3 / passes
            prof = profile_breakdown(lambda: run(runner), batches=1)  # noqa: B023
            device_ms = prof.get("device_ms_per_batch")
            rows[name] = {"ms_per_pass": ms, "device_ms_per_pass": device_ms,
                          "device_idle_share": (1 - device_ms / ms)
                          if isinstance(device_ms, float) else "not measured",
                          "device_ops_per_pass": prof.get("kernels_per_batch", "not measured"),
                          "host_calls_per_pass": prof.get("host_calls_per_batch",
                                                          "not measured"),
                          "losses": losses[name][0]}
        every = losses["eager"] + losses["graphed"]
        rel = max(abs(a - b) / max(abs(b), 1e-6) for p in every for a, b in zip(p, every[0]))
        out["branches"][str(key)] = {**rows, "losses_equal": all(p == every[0] for p in every),
                                     "loss_max_rel_diff": rel,
                                     "finite": all(math.isfinite(v) for v in every[0])}
    out["graphs"] = [str(k) for k in graphed.graphs]
    out["replays"] = graphed.replays
    # per branch: the capturing pass, the timed passes and the profiled one
    want = len(branches) * ((passes + 2) * len(batches) - 1)
    check(graphed.replays == want, f"{stage} validation: {graphed.replays} graph replays, "
          f"want {want}")
    return out


def check_validation_equal(v: dict) -> None:
    """Every pass of every branch finite, graphed and eager losses equal
    (float32: the same kernels in the same order)."""
    for key, b in v["branches"].items():
        check(b["finite"], f"{v['stage']} validation {key}: non-finite losses")
        check(b["losses_equal"], f"{v['stage']} validation {key}: graphed losses "
              f"{b['graphed']['losses']} against eager {b['eager']['losses']}")


def phase_serve_and_infer(work: str) -> dict:
    import numpy as np
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.noise import align
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.train.common import build_generator, get_tokenizer
    from consistent__style_transfer_torch.train.infer import make_transfer_step, transfer_split
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

    shape = (cfg.batch_size, cfg.max_len)
    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0
    zero_lstm_launches()
    t0 = time.perf_counter()
    with watch_graphs() as made:
        served = run_cli(["serve", *flags], "\n".join(requests) + "\n")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = fused_decode_logits.launches
    serve_cells = lstm_launches("serve", greedy_cells(serve_launches))
    serve_graphs = check_replayed(made, [shape], serve_batches, "serve")
    check(sinkhorn_cuda.launches == 0, "serve launched the Sinkhorn")
    check(len(served) == len(requests), f"serve printed {len(served)} lines for {len(requests)}")
    check(serve_launches == cfg.max_len * serve_batches,
          f"serve: {serve_launches} kernel launches, want {cfg.max_len} x {serve_batches}")

    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0
    zero_lstm_launches()
    t0 = time.perf_counter()
    with watch_graphs() as made:
        run_cli(["infer", *flags])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_launches = fused_decode_logits.launches
    infer_cells = lstm_launches("infer", greedy_cells(infer_launches))
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
    infer_graphs = check_replayed(made, [shape], infer_batches, "infer")

    # reference on a small input: the card's greedy ids (kernel head, a
    # graph replay) equal the CPU's (plain head) in float32 on the same
    # checkpoint; and the test split's .tsf lines, the card's from a graph
    # replayed for every batch but the first, equal the CPU's
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = make_config("yelp", dtype="float32", mode="test", **dirs)
    enc = [tokenizer.encode(r.split("\t", 1)[1])[: cfg.max_len] for r in requests[::125]]
    x, _ = align(enc, 0, cfg.max_len)
    labels = np.array([int(r[0]) for r in requests[::125]], np.int32)
    ids, lines = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_generator(cfg32, V, torch.device(dev))
        load_generator_params(cfg32, model)
        step = make_transfer_step(model)
        for _ in range(2):  # on the card: the eager first call, then a replay
            ids[dev] = step(torch.from_numpy(x).to(dev), torch.from_numpy(labels).to(dev)).cpu()
        lines[dev] = transfer_split(cfg32, model, tokenizer, "test")
    agree = (ids["cuda"] == ids["cpu"]).float().mean().item()
    check(agree == 1.0, f"f32 greedy ids on the card agree with the CPU on {agree:.3f} of tokens")
    check(lines["cuda"] == lines["cpu"], "f32 test-split lines on the card differ from the CPU's")

    result = {"V": V, "serve_requests": len(requests), "serve_batches": serve_batches,
              "serve_s": serve_s, "serve_sent_per_s": len(requests) / serve_s,
              "serve_launches": serve_launches, "infer_sentences": n_infer,
              "infer_batches": infer_batches, "infer_s": infer_s,
              "infer_sent_per_s": n_infer / infer_s, "infer_launches": infer_launches,
              "serve_graphs": serve_graphs, "infer_graphs": infer_graphs,
              "lstm_cell_launches": {"serve": serve_cells, "infer": infer_cells},
              "f32_card_vs_cpu_sentences": len(enc), "f32_card_vs_cpu_agree": agree,
              "f32_test_split_lines_equal_cpu": sum(map(len, lines["cpu"].values()))}
    print(json.dumps({"serve_infer": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 4
def profile_breakdown(fn, batches: int = 3, watch: tuple[str, ...] = ()) -> dict:
    """Device time per call of fn by kernel name (torch.profiler): the sum of
    the kernels' own device time, user annotations (such as the optimizer's
    ranges) left out; ``watch`` names kernels reported whatever their rank;
    and the host's launch calls (``HOST_LAUNCH_CALLS``: kernel launches,
    graph launches, copies) per call, with the host time they took. Where the profiler gives no device
    time, the breakdown says "not measured"."""
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
    host_calls: dict[str, int] = {}
    host_us: dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCH_CALLS:
            host_calls[e.name] = host_calls.get(e.name, 0) + 1
            host_us[e.name] = host_us.get(e.name, 0.0) + e.cpu_time_total
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
            "host_calls_per_batch": {k: v / batches for k, v in sorted(host_calls.items())},
            "host_call_ms_per_batch": {k: v / batches / 1e3 for k, v in sorted(host_us.items())},
            "top": [row(n) for n in top[:10]],
            "watched": [row(n) for n in top if any(w in n for w in watch)]}


def phase_full_width(card: str, head_graph_ms: float) -> dict:
    """Greedy transfer at the yelp serving shape (V=10000, L=18, B=256,
    bf16, seeded weights): the graphed step (``make_transfer_step``, one CUDA
    graph replay a batch) beside the eager decode on the same batch in this
    run: host ms a batch, device ms, device operations, host launch calls,
    idle share, and the graph's nodes; the decode head's time inside the
    replay (profiler kernel time a call) beside its graph-timed time from
    phase 2 (``head_graph_ms``). Graphed ids equal eager ones in float32; in
    bf16 at most BF16_TOKEN_SHARE of the tokens differ."""
    import torch

    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.train.common import generator_call
    from consistent__style_transfer_torch.train.infer import make_transfer_step

    g = torch.Generator().manual_seed(1)
    xs = [torch.randint(3, YELP_V, (YELP_B, YELP_L), generator=g, dtype=torch.int32).cuda()
          for _ in range(4)]
    ls = [torch.randint(0, 2, (YELP_B,), generator=g, dtype=torch.int32).cuda() for _ in xs]

    def steps(dtype):
        model = DenoiseSeq2Seq(n_vocab=YELP_V, n_class=2, max_len=YELP_L, seed=0)
        model = model.to("cuda", dtype).eval()

        @torch.inference_mode()
        def eager(x, labels):
            return generator_call(model, x, labels, None, 1 - labels, mode="greedy")

        return make_transfer_step(model), eager

    # graphed against eager ids, 4 batches each (the first graphed call is
    # the eager warm-up and capture, the rest replays)
    agree = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        graphed, eager = steps(dtype)
        got = torch.stack([graphed(x, lab).clone() for x, lab in zip(xs, ls)])
        want = torch.stack([eager(x, lab) for x, lab in zip(xs, ls)])
        agree[name] = {"batches": len(xs), "tokens": want.numel(),
                       "differing_share": float((got != want).float().mean())}
    check(agree["float32"]["differing_share"] == 0.0,
          f"f32 graphed ids differ from eager on {agree['float32']['differing_share']} of tokens")
    check(agree["bfloat16"]["differing_share"] <= BF16_TOKEN_SHARE,
          f"bf16 graphed ids differ from eager on {agree['bfloat16']['differing_share']}")

    graphed, eager = steps(torch.bfloat16)
    x, labels = xs[0], ls[0]
    n, result = 20, {"card": card, "dtype": "bfloat16", "V": YELP_V, "L": YELP_L, "B": YELP_B,
                     "graphed_vs_eager_ids": agree, "bf16_token_share_bound": BF16_TOKEN_SHARE}
    for name, step in (("eager", eager), ("graphed", graphed)):
        for _ in range(3):
            step(x, labels)
        torch.cuda.synchronize()
        fused_decode_logits.launches = 0
        sinkhorn_cuda.launches = 0
        zero_lstm_launches()
        t0 = time.perf_counter()
        for _ in range(n):
            ids = step(x, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        launches = fused_decode_logits.launches
        check(sinkhorn_cuda.launches == 0, "serving launched the Sinkhorn")
        check(launches == YELP_L * n, f"{name}: {launches} launches, want {YELP_L} x {n}")
        cells = lstm_launches(f"full_width_{name}", 3 * YELP_L * n)
        check(ids.shape == (YELP_B, YELP_L) and ids.dtype == torch.int32, "ids shape/dtype")
        check(bool(((ids >= 0) & (ids < YELP_V)).all()), "ids out of range")
        prof = profile_breakdown(lambda: step(x, labels), watch=("ffn_", "vocab_argmax"))  # noqa: B023
        device_ms = prof.get("device_ms_per_batch")
        result[name] = {
            "ms_per_batch": ms, "sent_per_s": YELP_B * 1e3 / ms,
            "launches_per_batch": launches / n, "device_ms_per_batch": device_ms,
            "lstm_cell_launches_per_batch": cells["forward"] / n,
            "device_ops_per_batch": prof.get("kernels_per_batch", "not measured"),
            "host_calls_per_batch": prof.get("host_calls_per_batch", "not measured"),
            "device_idle_share": (1 - device_ms / ms) if isinstance(device_ms, float)
            else "not measured", "profile": prof,
            **peak_memory(lambda: step(x, labels))}  # noqa: B023
    result["graphed"]["graph_nodes"] = graph_nodes(graphed.runner.graphs[(YELP_B, YELP_L)])
    # the decode head inside the replay: its two kernels' profiled time a call
    watched = result["graphed"]["profile"].get("watched", [])
    head_calls = sum(r["calls_per_batch"] for r in watched if "ffn_" in r["name"])
    result["head_in_graph_ms_per_call"] = (
        sum(r["ms_per_batch"] for r in watched) / head_calls if head_calls else "not measured")
    result["head_graph_timed_ms_per_call"] = head_graph_ms
    result["speedup_host"] = result["eager"]["ms_per_batch"] / result["graphed"]["ms_per_batch"]
    # what the rest of the script reads: the graphed step, as serving runs
    result.update(ms_per_batch=result["graphed"]["ms_per_batch"],
                  launches_per_batch=result["graphed"]["launches_per_batch"])
    print(json.dumps({"full_width": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 5
def count_lines(files) -> int:
    n = 0
    for path in files:
        with open(path, encoding="utf-8") as f:
            n += sum(1 for line in f if line.strip())
    return n


def replays_against_eager(params: list, state: list, gens: list, eager, graphed, n: int) -> dict:
    """``n`` eager steps and ``n`` graph replays, each run from the same saved
    ``state`` (the ``params`` first, then the Adam states; restored in place,
    as the graphs hold their addresses) and generator states; step i of a
    run is ``eager(i)`` or ``graphed(i)``, each returning its losses. The
    losses, the parameters after the run and the generators' states are
    compared, against phase 8's float32 tolerances."""
    import torch

    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in state]
    saved_gens = [g.get_state() for g in gens]
    runs = []
    for step in (eager, graphed):
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        for g, v in zip(gens, saved_gens):
            g.set_state(v)
        losses = torch.cat([step(i).float().flatten().clone() for i in range(n)])
        torch.cuda.synchronize()
        runs.append((losses, [p.detach().clone() for p in params], [g.get_state() for g in gens]))
    (l0, p0, g0), (l1, p1, g1) = runs
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p1, p0)])
    move = torch.cat([(a - b).abs().flatten() for a, b in zip(p0, saved[:len(params)])])
    return {"steps": n, "loss_max_rel_diff": float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max()),
            "param_mean_abs_diff": float(diff.mean()), "param_max_abs_diff": float(diff.max()),
            "param_mean_abs_move": float(move.mean()),
            "param_share": float(diff.mean() / move.mean().clamp_min(1e-30)),
            "generator_states_equal": all(torch.equal(a, b) for a, b in zip(g0, g1)),
            "finite": bool(torch.isfinite(l0).all()), "tolerance": GRAPH_TOL["float32"]}


def check_replays(e: dict, what: str) -> None:
    tol = e["tolerance"]
    check(e["finite"], f"{what}: non-finite eager losses")
    check(e["loss_max_rel_diff"] <= tol["loss_rel"],
          f"{what}: replay losses {e['loss_max_rel_diff']} apart (relative)")
    check(e["param_share"] <= tol["param_share"],
          f"{what}: replay parameters {e['param_share']} of their move apart")
    check(e["generator_states_equal"], f"{what}: replays moved the generators otherwise")


def adam_state(params: list, opts) -> list:
    """``params``, then every Adam state tensor of ``opts``, in a fixed order."""
    import torch

    return list(params) + [t for o in opts for st in o.adam.state.values()
                           for t in st.values() if isinstance(t, torch.Tensor)]


def real_label_batch(cfg, labeler, corpus) -> dict:
    """The Sinkhorn on one real WMD-label batch: the first ``batch_size``
    train sentences noised twice as the pretrain collate noises them, the
    labeler's (p, q, D) from them; both names against the plain version
    (rtol 1e-4, atol 1e-5), the labeler's host times a batch, its device
    time split into the Sinkhorn, the host-to-device copies and the rest,
    the valid atoms a side, and ``sinkhorn_times``."""
    import numpy as np
    import torch

    from consistent__style_transfer_torch.data.noise import transfer_noise_arrays
    from consistent__style_transfer_torch.kernels.sinkhorn import (
        sinkhorn_pallas,
        sinkhorn_pallas_cr,
    )
    from consistent__style_transfer_torch.ops.emd import sinkhorn_ot_cost

    B, L = cfg.batch_size, cfg.max_len
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
    # valid atoms a side: the pair with the most sets the kernel's time; a
    # side over 32 atoms takes the kernel's exact shared-memory loop
    n_on, m_on = (p > 0).sum(-1).float(), (q > 0).sum(-1).float()
    return {"atoms": (p.shape[1], q.shape[1]), "pair_inputs_ms_host": pair_inputs_ms,
            "valid_atoms": {"mean": [n_on.mean().item(), m_on.mean().item()],
                            "max": [n_on.max().item(), m_on.max().item()],
                            "pairs_over_16": int(((n_on > 16) | (m_on > 16)).sum()),
                            "pairs_over_32": int(((n_on > 32) | (m_on > 32)).sum())},
            "label_pairs_ms_host": label_pairs_ms, "label_device": label_device,
            "max_abs_err": err, **sinkhorn_times(p, q, D)}


def pretrain_replays(cfg, V: int, corpus, labeler, work: str, what: str = "pretrain") -> dict:
    """The pretrain step of ``cfg``'s dumps in float32 with dropout on:
    graph replays of two flag tuples (every tower; the matcher frozen,
    captured while a save of the matcher, what a freeze's epoch end leaves,
    is pending on the saver's thread) against as many eager steps from one
    saved state (``replays_against_eager``), printed and checked."""
    import torch

    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.train.common import (build_classifier, build_lm,
                                                               build_matcher)
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.pretrain import (TASKS, make_pretrain_steps,
                                                                 step_inputs)
    from consistent__style_transfer_torch.train.state import AdamWithClip, AsyncSaver

    B, L, device = cfg.batch_size, cfg.max_len, torch.device("cuda")
    full, frozen = (True, True, True), (True, False, True)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the classifier's convolutions in float32
    towers = {"cls": build_classifier(cfg, V, device), "mat": build_matcher(cfg, V, device),
              "dn": build_lm(cfg, V, device)}
    for t in TASKS:
        towers[t].load_state_dict(torch.load(os.path.join(cfg.ds_dump_dir, "pretrain", f"{t}.pth"),
                                             map_location=device, weights_only=True))
    opt = AdamWithClip([p for t in TASKS for p in towers[t].parameters()], cfg.pretrain_lr,
                       cfg.pretrain_clip)
    f32_step, _ = make_pretrain_steps(towers, opt)
    gen = torch.Generator(device).manual_seed(7)
    saver, pending = AsyncSaver(), []

    def drain():
        pending.append(saver._q.unfinished_tasks)
        saver.wait()

    runner = GraphedStep(lambda inputs, flags: f32_step(inputs, flags, gen), (gen,),
                         before_capture=drain)
    stream = iter(DevicePrefetcher(make_batches(corpus, B, L, "pretrain", shuffle=True, seed=2,
                                                wmd_labeler=labeler), device))
    try:
        fixed = [next(stream)[1] for _ in range(STEP_REPLAYS + 2)]
    finally:
        stream.close()
    order = [full, frozen] + [full, frozen, full] + [frozen] * (STEP_REPLAYS - 3)

    def losses(parts):
        return torch.stack([parts[t] for t in TASKS if t in parts])

    def graphed_call(i):
        return losses(runner({k: fixed[i][k] for k in step_inputs(order[i])}, order[i]))

    graphed_call(0)
    saver.submit(towers["mat"], os.path.join(work, f"mat_at_freeze_{cfg.dataset}.pth"))
    graphed_call(1)  # drains the pending save, then captures
    saver.close()
    check(sorted(runner.graphs) == [frozen, full], f"captured {sorted(runner.graphs)}")
    replay = replays_against_eager(
        [p for t in TASKS for p in towers[t].parameters()],
        adam_state([p for t in TASKS for p in towers[t].parameters()], [opt]), [gen],
        lambda i: losses(f32_step(fixed[i + 2], order[i + 2], gen)),
        lambda i: graphed_call(i + 2), STEP_REPLAYS)
    replay.update(flags=[list(f) for f in order[2:]], pending_saves_at_captures=pending,
                  graph_nodes={str(k): graph_nodes(g) for k, g in runner.graphs.items()},
                  L=L, B=B)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    del towers, opt, runner, fixed
    print(json.dumps({f"{what}_replay_vs_eager": replay}), flush=True)
    check_replays(replay, what)
    return replay


def phase_pretrain(work: str, card: str) -> dict:
    """``w2v`` and ``pretrain --epochs 1`` through the CLI (its steps
    replaying one CUDA graph, of the flags (True, True, True)), then the
    Sinkhorn on a real label batch; the steady step, eager and graphed;
    and, in float32 with dropout on, graph replays of two flag tuples (the
    second captured after a freeze, with a best-weight save still pending
    on the saver's thread) against as many eager steps from one state."""
    import numpy as np
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM
    from consistent__style_transfer_torch.train.common import (
        build_classifier,
        build_lm,
        build_matcher,
        get_corpus,
        get_tokenizer,
        get_w2v,
    )
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.pretrain import (
        TASKS,
        make_pretrain_steps,
        step_inputs,
    )
    from consistent__style_transfer_torch.train.state import AdamWithClip

    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"), log_dir=os.path.join(work, "log"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("yelp", **dirs)
    B, L = cfg.batch_size, cfg.max_len
    tokenizer = get_tokenizer(cfg)  # phase 3's BPE dump
    V = len(tokenizer)
    # the WMD word2vec through the CLI: the native hogwild trainer, 10 epochs
    t0 = time.perf_counter()
    run_cli(["w2v", *flags])
    w2v_s = time.perf_counter() - t0
    check(os.path.exists(cfg.w2v_path), f"w2v wrote no {cfg.w2v_path}")
    log(f"word2vec (10 epochs, native) in {w2v_s:.1f} s")
    n_train, n_dev = count_lines(cfg.train_files()), count_lines(cfg.split_files("dev"))
    labeled = n_train // B + -(-n_dev // B)  # train drops its last partial batch

    sinkhorn_cuda.launches = 0
    fused_decode_logits.launches = 0
    zero_lstm_launches()
    t0 = time.perf_counter()
    with watch_graphs() as made:
        run_cli(["pretrain", *flags, "--epochs", "1"])
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    launches = sinkhorn_cuda.launches
    check(launches == labeled,
          f"pretrain: {launches} Sinkhorn launches, want one per labeled batch = {labeled}")
    check(fused_decode_logits.launches == 0, "pretrain launched the decode head")
    lstm_launches("pretrain", 0)  # the scorers only: no LSTM

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
    cli_graphs = check_replayed(made, [(True, True, True)], epoch["train_steps"], "pretrain",
                                steps=2)
    # its validation: every dev batch a replay of the eval step's graph but the first
    check(epoch["val_s"] > 0, f"pretrain logged val_s {epoch.get('val_s')}")
    cli_val_graphs = check_replayed(made, [(True, True, True)], -(-n_dev // B),
                                    "pretrain validation", steps=2, index=1)

    # the Sinkhorn on one real label batch (after the counts were read)
    labeler = SinkhornWmdLabeler(get_w2v(cfg, tokenizer), tokenizer, max_atoms=L + L // 2,
                                 device=torch.device("cuda"))
    corpus = get_corpus(cfg, "train", tokenizer)
    real = real_label_batch(cfg, labeler, corpus)

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
    full, frozen = (True, True, True), (True, False, True)
    try:
        def step():
            return train_step(next(stream)[1], full, generator)

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
        peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        breakdown = profile_breakdown(step, batches=4, watch=("sinkhorn",))
        # the same step as the CLI's epoch runs it: one graph replay a step
        runner = GraphedStep(lambda inputs, flags: train_step(inputs, flags, generator),
                             (generator,))
        keys = step_inputs(full)

        def graphed_step():
            arrays = next(stream)[1]
            return runner({k: arrays[k] for k in keys}, full)

        graphed = steady_step(graphed_step)
        graphed["graph_nodes"] = graph_nodes(runner.graphs[full])
        check(all(bool(torch.isfinite(v)) for v in graphed_step().values()),
              "non-finite graphed pretrain losses")
    finally:
        stream.close()
    del runner
    device_ms = breakdown.get("device_ms_per_batch")
    idle = (1 - device_ms / steady_ms) if isinstance(device_ms, float) else "not measured"

    # replays against eager steps: float32 towers from the dumps, dropout on
    replay = pretrain_replays(cfg, V, corpus, labeler, work)
    # validation passes, graphed against eager, float32, across a freeze
    val_replay = validation_passes(make_config("yelp", dtype="float32", **dirs), "pretrain",
                                   torch.device("cuda"))
    print(json.dumps({"pretrain_validation_replay_vs_eager": val_replay}), flush=True)
    check_validation_equal(val_replay)
    result = {"card": card, "dtype": "bfloat16 autocast, float32 parameters", "V": V, "L": L,
              "B": B, "scorer": "6 layers / 8 heads / d=512", "w2v_epochs": 10,
              "w2v_trainer": "native", "w2v_s": w2v_s,
              "train_sentences": n_train, "dev_sentences": n_dev, "pretrain_cli_s": pretrain_s,
              "train_steps": epoch["train_steps"], "ms_per_step_epoch": ms_per_step,
              "sent_per_s_epoch": B * 1e3 / ms_per_step, "ms_per_step_steady": steady_ms,
              "sent_per_s_steady": B * 1e3 / steady_ms, "peak_memory_gb_steady": peak_gb,
              "peak_reserved_gb_steady": peak_reserved_gb,
              "sinkhorn_launches": launches, "labeled_batches": labeled,
              "sinkhorn_label_batch": real, "device_idle_share": idle,
              "profile_per_step": breakdown, "graphed": graphed, "cli_graphs": cli_graphs,
              "replay_vs_eager": replay, "cli_validation_graphs": cli_val_graphs,
              "validation_replay_vs_eager": val_replay,
              "speedup_host": steady_ms / graphed["ms_per_step_steady"],
              "val": {k: v for k, v in epoch.items() if k.startswith("val")}}
    print(json.dumps({"pretrain": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 6
def read_events(cfg, stage: str) -> list[dict]:
    with open(os.path.join(cfg.log_dir, cfg.dataset, stage, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_finite_losses(events: list[dict], keys: tuple[str, ...], stage: str) -> dict:
    seen = {k: [e[k] for e in events if k in e] for k in keys}
    check(all(seen.values()), f"{stage}: a loss was never logged: { {k: len(v) for k, v in seen.items()} }")
    bad = {k: v for k, v in seen.items() if not all(math.isfinite(x) for x in v)}
    check(not bad, f"{stage}: non-finite logged losses {bad}")
    return {k: v[-1] for k, v in seen.items()}


def peak_memory(fn) -> dict:
    """Peak allocated and reserved device memory over one fn() call, the
    allocator's cache emptied first (a CUDA graph's private pool stays
    reserved)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return {"peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def steady_step(step, batches: int = 20) -> dict:
    """ms per step on the host clock over ``batches`` calls of ``step`` after
    3 warm-up calls, ending in a synchronise; peak device memory over them;
    then a profiler breakdown of 2 more calls and the idle share."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(batches):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / batches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a CUDA graph's private pool is reserved, not allocated, between replays
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    prof = profile_breakdown(step, batches=2)
    device_ms = prof.get("device_ms_per_batch")
    idle = (1 - device_ms / ms) if isinstance(device_ms, float) else "not measured"
    return {"ms_per_step_steady": ms, "peak_memory_gb_steady": peak_gb,
            "peak_reserved_gb_steady": reserved_gb,
            "device_ms_per_step": device_ms, "device_idle_share": idle,
            "kernels_per_step": prof.get("kernels_per_batch", "not measured"),
            "host_calls_per_step": prof.get("host_calls_per_batch", "not measured"),
            "host_call_ms_per_step": prof.get("host_call_ms_per_batch", "not measured"),
            "top_device_ops": prof.get("top", "not measured")}


def warmup_replays(cfg, V: int, device, g_path: str, corpus) -> dict:
    """The warmup step of ``cfg.backbone`` in float32 with dropout on, from
    ``g_path``: graph replays against as many eager steps from one saved
    state (``replays_against_eager``), after the eager first call and the
    capture, at the stage's batch size."""
    import torch

    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.train.common import build_generator
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.state import AdamWithClip
    from consistent__style_transfer_torch.train.warmup import WARMUP_INPUTS, make_warmup_steps

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    model = build_generator(cfg, V, device, training=True)
    model.load_state_dict(torch.load(g_path, map_location=device, weights_only=True), strict=True)
    opt = AdamWithClip(model.parameters(), cfg.warmup_lr, cfg.warmup_clip)
    step, _ = make_warmup_steps(model, opt)  # float32
    gen = torch.Generator(device).manual_seed(8)
    runner = GraphedStep(lambda inputs, _: step(inputs, gen), (gen,))
    it = iter(DevicePrefetcher(make_batches(corpus, cfg.warmup_batch_size, cfg.max_len, "warmup",
                                            shuffle=True, seed=3), device))
    try:
        fixed = [{k: next(it)[1][k] for k in WARMUP_INPUTS} for _ in range(STEP_REPLAYS + 1)]
    finally:
        it.close()
    runner(fixed[0])  # the eager step, then the capture
    params = list(model.parameters())
    out = replays_against_eager(params, adam_state(params, [opt]), [gen],
                                lambda i: step(fixed[i + 1], gen),
                                lambda i: runner(fixed[i + 1]), STEP_REPLAYS)
    out.update(backbone=cfg.backbone, batch_size=cfg.warmup_batch_size, p_drop=cfg.p_drop,
               graph_nodes=graph_nodes(runner.graphs[None]))
    return out


def build_optimize(c, V: int, device, dropout: bool = True, group=None):
    """The optimize stage of config ``c`` on its dumps: the frozen scorers,
    the G that ``load_generator_params`` finds, dropout off in every module
    unless ``dropout``, an Adam each for G and D (reducing over ``group``),
    the fused steps, D's accumulator and the two generators (seeds 1 and
    2): (models, steps, opts, acc, gens)."""
    import torch

    from consistent__style_transfer_torch.train.optimize import (OptimizeModels, load_frozen,
                                                                 load_generator_params,
                                                                 make_optimize_steps)
    from consistent__style_transfer_torch.train.state import AdamWithClip

    models = OptimizeModels(c, V, device)
    load_frozen(c, models)
    load_generator_params(c, models.generator)
    if not dropout:
        for m in (models.generator, models.classifier, models.matcher, models.nt_checker,
                  models.disc):
            for sub in m.modules():
                if hasattr(sub, "p_drop"):
                    sub.p_drop = 0.0
    opts = (AdamWithClip(models.generator.parameters(), c.optimize_lr, c.optimize_clip,
                         group=group),
            AdamWithClip(models.disc.parameters(), c.optimize_lr, c.optimize_clip, group=group))
    steps = make_optimize_steps(c, models, *opts, group=group)
    acc = [torch.zeros_like(p) for p in models.disc.parameters()]
    gens = (torch.Generator(device).manual_seed(1), torch.Generator(device).manual_seed(2))
    return models, steps, opts, acc, gens


def optimize_replays(c, V: int, device, fixed: list, what: str) -> dict:
    """The fused optimize step of config ``c`` (float32) with dropout on and
    the coins drawn: both branches captured on ``fixed[0]`` (D applied) and
    ``fixed[1]``, then ``len(fixed) - 2`` graph replays against as many
    eager steps from one saved state (``replays_against_eager``; D applied
    every ``d_update_every``-th), printed as ``<what>_replay_vs_eager`` and
    checked."""
    import torch

    from consistent__style_transfer_torch.train.optimize import GraphedFusedStep

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    models, steps, opts, acc, gens = build_optimize(c, V, device)
    scale = torch.ones((), device=device)
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, scale)
    runner(fixed[0], True)
    runner(fixed[1], False)
    check(sorted(runner.graphs) == [False, True], f"{what}: both branches were not captured")
    params = [p for m in (models.generator, models.disc) for p in m.parameters()]

    def losses(out):
        aux, d_loss = out
        return torch.stack([aux[k].float() for k in ("loss", "G", "STI", "CP", "BK")]
                           + [d_loss.float()])

    def applies(i):
        return i % c.d_update_every == 0

    replay = replays_against_eager(
        params, adam_state(params + acc, opts), gens,
        lambda i: losses(steps.fused_step(fixed[i + 2], acc, applies(i), *gens, scale)),
        lambda i: losses(runner(fixed[i + 2], applies(i))), len(fixed) - 2)
    replay.update(p_drop=c.p_drop, dtype=c.dtype, L=c.max_len, B=c.batch_size)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    del models, steps, opts, acc, runner
    print(json.dumps({f"{what}_replay_vs_eager": replay}), flush=True)
    check_replays(replay, f"{what} optimize")
    return replay


def optimize_steady(steps, acc: list, gens, d_every: int, stream, graphed: bool = True,
                    batches: int = 10, cells: tuple[int, int] | None = None,
                    what: str = "optimize") -> dict:
    """``steady_step`` of the fused optimize step on the batches of
    ``stream`` (a prefetcher's iterator, closed here), D applied every
    ``d_every``-th: a ``GraphedFusedStep`` replay, or the eager step; one
    more step's losses checked finite; the graphed step's captured branches
    and graph nodes, and the fused LSTM cell's (forward, backward) launches
    each branch's graph replays, checked equal to ``cells`` (kept as
    ``<what>_graph_<branch>``)."""
    import torch

    from consistent__style_transfer_torch.train.optimize import GraphedFusedStep

    if graphed:
        runner = GraphedFusedStep(steps.fused_step, acc, *gens, torch.ones((), device=acc[0].device))
    st = {"i": 0}

    def step():
        batch, do_apply = next(stream)[1], st["i"] % d_every == 0
        st["i"] += 1
        return runner(batch, do_apply) if graphed else steps.fused_step(batch, acc, do_apply,
                                                                       *gens)

    try:
        out = steady_step(step, batches=batches)
        aux, d_loss = step()
        check(all(math.isfinite(v.item()) for v in (*aux.values(), d_loss)),
              f"non-finite {'graphed' if graphed else 'eager'} optimize losses")
    finally:
        stream.close()
    if graphed:
        out["captured_branches"] = sorted(runner.graphs)
        out["graph_nodes"] = {str(k): graph_nodes(g) for k, g in runner.graphs.items()}
        out["lstm_cell_launches_per_replay"] = {
            str(k): lstm_launches(f"{what}_graph_{k}", *cells, counts=replayed_cells(runner, k))
            for k in runner.graphs}
    return out


def replayed_cells(runner, key) -> tuple[int, int]:
    """The fused LSTM cell's (forward, backward) launches that each replay
    of ``runner``'s graph of ``key`` adds (the calls its capture made)."""
    from consistent__style_transfer_torch.kernels.lstm_cell import lstm_cell_bwd, lstm_cell_fwd

    n = dict(runner.replay_launches[key])
    return n.get(lstm_cell_fwd, 0), n.get(lstm_cell_bwd, 0)


def phase_training(work: str, card: str) -> dict:
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.train.common import (
        build_generator,
        get_corpus,
        get_tokenizer,
    )
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.state import AdamWithClip, newest_checkpoint
    from consistent__style_transfer_torch.train.warmup import WARMUP_INPUTS, make_warmup_steps

    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"), log_dir=os.path.join(work, "log"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("yelp", **dirs)
    L, device = cfg.max_len, torch.device(cfg.device)
    tokenizer = get_tokenizer(cfg)  # phase 3's BPE dump
    V = len(tokenizer)
    n_train = count_lines(cfg.train_files())
    task = os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}")
    # phase 3's seeded G_epoch_1.pth would sort after G_epoch_0.pth: the
    # infer below must read what optimize writes
    shutil.rmtree(task, ignore_errors=True)

    def launches_during(argv, made=None):
        fused_decode_logits.launches = 0
        sinkhorn_cuda.launches = 0
        zero_lstm_launches()
        t0 = time.perf_counter()
        with watch_graphs() as graphed:
            run_cli(argv)
        torch.cuda.synchronize()
        check(sinkhorn_cuda.launches == 0, f"{argv[0]} launched the Sinkhorn")
        if made is not None:
            made[:] = graphed
        return fused_decode_logits.launches, time.perf_counter() - t0

    def load_strict(path):
        check(os.path.exists(path), f"missing {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        DenoiseSeq2Seq(V, cfg.n_class, L).load_state_dict(sd, strict=True)
        check(all(bool(torch.isfinite(v).all()) for v in sd.values()), f"{path}: non-finite weights")

    # 1. warmup, one epoch (the default), its steps replaying one graph
    made = []
    head, warmup_s = launches_during(["warmup", *flags], made)
    check(head == 0, f"warmup launched the decode head {head} times")
    load_strict(os.path.join(cfg.ds_dump_dir, "warmup", "G.pth"))
    events = read_events(cfg, "warmup")
    warm_losses = check_finite_losses(events, ("dn_loss", "val_loss"), "warmup")
    warm_epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // cfg.warmup_batch_size
    check(warm_epoch["train_steps"] == want, f"warmup: {warm_epoch['train_steps']} steps, want {want}")
    warm_graphs = check_replayed(made, [None], want, "warmup", steps=2)
    # the teacher-forced decode, 3 x L cells a step with a backward each;
    # its validation's decodes forward only
    warm_cells = lstm_launches("warmup", None, 3 * L * want
                               * sum("train_steps" in e for e in events))
    n_dev = count_lines(cfg.split_files("dev"))
    check(warm_epoch["val_s"] > 0, f"warmup logged val_s {warm_epoch.get('val_s')}")
    warm_val_graphs = check_replayed(made, [None], -(-n_dev // cfg.warmup_batch_size),
                                     "warmup validation", steps=2, index=1)

    # 2. optimize, one epoch instead of ten (a stated reduction); its fused
    # step is GraphedFusedStep, its validation a graph through step_runner
    head, optimize_s = launches_during(["optimize", *flags, "--epochs", "1"], made)
    check(head == 0, f"optimize launched the decode head {head} times")
    best = os.path.join(task, "G_epoch_0.pth")
    load_strict(best)
    events = read_events(cfg, f"optimize-{cfg.ver}")
    opt_losses = check_finite_losses(events, ("G", "STI", "CP", "BK", "D", "loss", "val_loss"),
                                     "optimize")
    opt_epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // cfg.batch_size
    check(opt_epoch["train_steps"] == want, f"optimize: {opt_epoch['train_steps']} steps, want {want}")
    opt_cells = lstm_launches("optimize", None, fused_step_cells(cfg)[1] * want)
    check(opt_cells["forward"] > fused_step_cells(cfg)[0] * want,
          f"optimize: {opt_cells} LSTM cell launches, want the steps' and validation's")
    want = math.ceil(want / cfg.d_update_every)
    check(opt_epoch["d_applies"] == want, f"optimize: D applied {opt_epoch['d_applies']}, want {want}")
    check(opt_epoch["val_s"] > 0, f"optimize logged val_s {opt_epoch.get('val_s')}")
    opt_val_graphs = check_replayed(made, [None], -(-n_dev // cfg.batch_size),
                                    "optimize validation")

    # 3. infer from the checkpoint optimize wrote
    check(newest_checkpoint(task) == best, f"infer would read {newest_checkpoint(task)}")
    infer_launches, infer_s = launches_during(["infer", *flags], made)
    infer_batches = sum(-(-count_lines(cfg.split_files(s)) // cfg.batch_size)
                        for s in ("train", "test"))
    check(infer_launches == L * infer_batches > 0,
          f"infer: {infer_launches} decode-head launches, want {L} x {infer_batches}")
    infer_graphs = check_replayed(made, [(cfg.batch_size, L)], infer_batches, "infer")
    infer_cells = lstm_launches("infer_after_optimize", greedy_cells(infer_launches))

    # 4. steady state of the same step functions, on batches from the
    # prefetcher, from the checkpoints just written
    corpus = get_corpus(cfg, "train", tokenizer)
    gen = torch.Generator(device).manual_seed(1)

    def stream(stage, batch_size):
        return iter(DevicePrefetcher(make_batches(corpus, batch_size, L, stage, shuffle=True,
                                                  seed=1), device))

    zero_lstm_launches()
    model = build_generator(cfg, V, device, training=True)
    model.load_state_dict(torch.load(os.path.join(cfg.ds_dump_dir, "warmup", "G.pth"),
                                     map_location=device, weights_only=True), strict=True)
    warm_step, _ = make_warmup_steps(model, AdamWithClip(model.parameters(), cfg.warmup_lr,
                                                         cfg.warmup_clip), torch.bfloat16)
    batches = stream("warmup", cfg.warmup_batch_size)
    runner = GraphedStep(lambda inputs, _: warm_step(inputs, gen), (gen,))

    def graphed_warm():
        arrays = next(batches)[1]
        return runner({k: arrays[k] for k in WARMUP_INPUTS})

    try:
        warm_steady = steady_step(lambda: warm_step(next(batches)[1], gen))
        warm_graphed = steady_step(graphed_warm)
        check(math.isfinite(graphed_warm().item()), "non-finite graphed warmup loss")
    finally:
        batches.close()
    warm_graphed["graph_nodes"] = graph_nodes(runner.graphs[None])
    del model, warm_step, runner
    warm_replay = warmup_replays(cfg, V, device, os.path.join(cfg.ds_dump_dir, "warmup", "G.pth"),
                                 corpus)
    print(json.dumps({"warmup_replay_vs_eager": warm_replay}), flush=True)
    check_replays(warm_replay, "warmup")

    models, steps, _, acc, gens = build_optimize(cfg, V, device)
    opt_steady = optimize_steady(steps, acc, gens, cfg.d_update_every,
                                 stream("optimize", cfg.batch_size), graphed=False, batches=20)
    check(fused_decode_logits.launches == infer_launches and sinkhorn_cuda.launches == 0,
          "a training step launched a kernel")
    del models, steps, acc

    # validation passes, graphed against eager, float32, from these dumps
    f32 = make_config("yelp", dtype="float32", **dirs)
    val_replay = {stage: validation_passes(f32, stage, device) for stage in ("warmup", "optimize")}
    print(json.dumps({"training_validation_replay_vs_eager": val_replay}), flush=True)
    for v in val_replay.values():
        check_validation_equal(v)
    check(fused_decode_logits.launches == infer_launches, "validation launched the decode head")
    steady_cells = lstm_launches("training_steady_and_validation", None, None)

    def rates(epoch, steady, batch_size):
        ms_epoch = epoch["train_s"] * 1e3 / epoch["train_steps"]
        return {"train_steps": epoch["train_steps"], "batch_size": batch_size,
                "ms_per_step_epoch": ms_epoch, "sent_per_s_epoch": batch_size * 1e3 / ms_epoch,
                **steady, "sent_per_s_steady": batch_size * 1e3 / steady["ms_per_step_steady"]}

    result = {"card": card, "dtype": "bfloat16 autocast, float32 parameters", "V": V, "L": L,
              "train_sentences": n_train, "scorer": "6 layers / 8 heads / d=512",
              "warmup": {"cli_s": warmup_s, **rates(warm_epoch, warm_steady, cfg.warmup_batch_size),
                         "graphed": warm_graphed, "cli_graphs": warm_graphs,
                         "speedup_host": warm_steady["ms_per_step_steady"]
                         / warm_graphed["ms_per_step_steady"],
                         "replay_vs_eager": warm_replay,
                         "cli_validation_graphs": warm_val_graphs, "val_s": warm_epoch["val_s"],
                         "validation_replay_vs_eager": val_replay["warmup"],
                         "losses": warm_losses, "decode_head_launches": 0,
                         "lstm_cell_launches": warm_cells},
              "optimize": {"cli_s": optimize_s, "epochs": 1, "d_applies": opt_epoch["d_applies"],
                           **rates(opt_epoch, opt_steady, cfg.batch_size),
                           "cli_validation_graphs": opt_val_graphs, "val_s": opt_epoch["val_s"],
                           "validation_replay_vs_eager": val_replay["optimize"],
                           "losses": opt_losses, "decode_head_launches": 0,
                           "lstm_cell_launches": opt_cells},
              "infer": {"s": infer_s, "batches": infer_batches, "graphs": infer_graphs,
                        "decode_head_launches": infer_launches,
                        "lstm_cell_launches": infer_cells},
              "steady_lstm_cell_launches": steady_cells}
    print(json.dumps({"training": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 7
def prepare_printed(lines: list[str]) -> tuple[list[dict], list[dict]]:
    """eval-prepare's printed timings, and its adversarial LR's parts where
    it fitted one (``evaluate/prepare.py``)."""
    import ast

    def parsed(prefix):
        return [ast.literal_eval(line.split(prefix, 1)[1]) for line in lines
                if line.startswith(prefix)]

    return parsed("[prepare] timings: "), parsed("[prepare] adversarial LR: ")


def fit_both_solvers(X, y, seed: int, what: str) -> tuple[dict, dict]:
    """The L1 LR on one matrix with the C++ solver (eval-prepare's) and the
    Python one (``prefer_native=False``): each fit's seconds, Newton
    iterations, inner passes, objective and stopping-rule violation, each
    held to the rule; and the objective of a C++ fit with TIGHT_EPS times
    the tolerance, near the minimum. Returns (numbers, fits)."""
    import numpy as np
    from scipy import sparse

    from consistent__style_transfer_torch.evaluate import l1r_native
    from consistent__style_transfer_torch.evaluate.lexicon import (
        MAX_NEWTON_ITER,
        TOL,
        L1LogisticRegression,
    )

    numbers, fits = {}, {}
    for solver, native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        lr = L1LogisticRegression(C=3, seed=seed, prefer_native=native).fit(X, y)
        fits[solver] = lr
        violation, bound = lr.stopping_violation(X, y)
        numbers[solver] = {"fit_s": time.perf_counter() - t0, "newton_iter": lr.n_iter_,
                           "inner_iter": lr.n_inner_iter_, "objective": lr.objective(X, y),
                           "nonzero_weights": int(np.count_nonzero(lr.coef_)),
                           "stopping_violation": violation, "stopping_bound": bound}
        check(lr.n_iter_ < MAX_NEWTON_ITER and violation <= bound * (1 + STOP_SLACK),
              f"{what}, {solver} solver: stopped at violation {violation} (rule: <= {bound}) "
              f"after {lr.n_iter_} Newton iterations")
    lr = fits["native"]
    s = np.where(np.asarray(y) == lr.classes_[1], 1.0, -1.0)
    Xb = sparse.hstack([sparse.csr_matrix(X, dtype=np.float64), np.ones((len(s), 1))],
                       format="csc")
    pos = int((s > 0).sum())
    eps = TOL * max(min(pos, len(s) - pos), 1) / len(s)
    t0 = time.perf_counter()
    w, newton, _ = l1r_native.solve_l1r_lr(Xb, s, 3.0, eps * TIGHT_EPS, 1000, seed)
    tight = L1LogisticRegression(C=3)
    tight.coef_, tight.intercept_, tight.classes_ = w[None, :-1], w[-1:], lr.classes_
    numbers["tight"] = {"fit_s": time.perf_counter() - t0, "newton_iter": newton,
                        "objective": tight.objective(X, y), "tolerance_factor": TIGHT_EPS}
    numbers["rows"], numbers["features"] = X.shape
    numbers["objective_rel_diff"] = (numbers["native"]["objective"]
                                     / numbers["python"]["objective"] - 1)
    for solver in ("native", "python"):
        numbers[solver]["above_tight_rel"] = (numbers[solver]["objective"]
                                              / numbers["tight"]["objective"] - 1)
    return numbers, fits


def adversarial_matrix(stem: str, vectorizer_path: str, seed: int) -> tuple:
    """The matrix eval-prepare fits this version's adversarial LR on, from
    its copies of the sentences (``<stem>.tsf``, ``<stem>.ori`` in
    ``eval_tmp``): (X, labels, the transform's seconds)."""
    from consistent__style_transfer_torch.evaluate.lexicon import load_model
    from consistent__style_transfer_torch.evaluate.naturalness import adversarial_train_set
    from consistent__style_transfer_torch.utils.io import read_lines

    x, y = adversarial_train_set(read_lines(f"{stem}.tsf"), read_lines(f"{stem}.ori"), seed=seed)
    vectorizer = load_model(vectorizer_path)
    t0 = time.perf_counter()
    X = vectorizer.transform(x)
    return X, y, time.perf_counter() - t0


def adversarial_stem(cfg, p: dict) -> str:
    """Where eval-prepare copies this version's adversarial sentences."""
    return f"{p['tmp']}/{cfg.dataset}-{cfg.ver}.train"


def saved_adversarial_lr(cfg, p: dict, printed: dict, what: str) -> dict:
    """eval-prepare's adversarial LR (``p["adv_model"]``) on the matrix it
    was fitted on, held to newGLMNET's stopping rule, with the parts of the
    fit eval-prepare printed (``printed``): the split of ``adv_lr_s``, the
    objective, the violation and its bound."""
    from consistent__style_transfer_torch.evaluate.lexicon import MAX_NEWTON_ITER, load_model

    X, y, _ = adversarial_matrix(adversarial_stem(cfg, p), p["vectorizer"], cfg.seed)
    saved = load_model(p["adv_model"])
    violation, bound = saved.stopping_violation(X, y)
    check(printed["newton_iter"] < MAX_NEWTON_ITER and violation <= bound * (1 + STOP_SLACK),
          f"{what} adversarial LR: stopped at violation {violation} (rule: <= {bound}) after "
          f"{printed['newton_iter']} Newton iterations")
    return {"split": {k: printed[k] for k in ("read_s", "transform_s", "fit_s", "newton_iter",
                                              "inner_iter")},
            "objective": saved.objective(X, y), "stopping_violation": violation,
            "stopping_bound": bound, "rows": X.shape[0], "features": X.shape[1]}


def adversarial_both_solvers(cfg, p: dict, origin, transfer, what: str) -> dict:
    """This version's adversarial LR fitted with both solvers on
    eval-prepare's matrix (``adversarial_matrix``): the transform's
    seconds, each fit's numbers (``fit_both_solvers``) and the NT each LR
    gives on the same test transfers."""
    from consistent__style_transfer_torch.evaluate.lexicon import load_model
    from consistent__style_transfer_torch.evaluate.naturalness import (
        UnigramNaturalnessClassifier,
        aggregate_judgments,
        generate_judgments,
    )

    X, y, transform_s = adversarial_matrix(adversarial_stem(cfg, p), p["vectorizer"], cfg.seed)
    numbers, fits = fit_both_solvers(X, y, cfg.seed, what)
    numbers["transform_s"] = transform_s
    vectorizer = load_model(p["vectorizer"])
    for solver, lr in fits.items():
        scorer = UnigramNaturalnessClassifier(lr, vectorizer)
        numbers[solver]["NT"] = aggregate_judgments(generate_judgments(
            scorer.score(origin), scorer.score(transfer)))
    return numbers


@contextlib.contextmanager
def eager_fasttext():
    """Inside the block the fastText fit runs its epoch chunks eagerly on
    the card (``text/fasttext_cls.py`` takes its runner from
    ``step_runner``, which makes CUDA graphs on the card)."""
    from consistent__style_transfer_torch.text import fasttext_cls

    real = fasttext_cls.step_runner
    fasttext_cls.step_runner = lambda fn, device: (lambda x, key=None: fn(x, key))
    try:
        yield
    finally:
        fasttext_cls.step_runner = real


def fasttext_epoch_cost(texts, labels, seed: int, graphed: bool, **kw) -> dict:
    """One epoch of the card's fastText fit, graphed or eager: its host
    seconds, from the first chunk of epoch 2 to that of epoch 3 in an
    unprofiled 3-epoch fit, the card synchronised at both marks (between
    them the epoch's chunks, its finiteness check and the next epoch's
    shuffled gather); its device ms, device operations and host launch
    calls from the profiler: graphed, a 2-epoch fit's less a 1-epoch fit's
    (the parsing, the upload and the captures fall out); eager, a whole
    1-epoch fit's (its upload, a few copies, included: the events of an
    eager epoch take tens of seconds to read); a profile with no device
    events, which the tracer gives now and then, is taken again, up to 3
    times; and the idle share 1 - device / host."""
    import torch

    from consistent__style_transfer_torch.text import fasttext_cls

    steps = -(-len(texts) // 64) if kw.get("sgd") != "sequential" else len(texts)
    chunks = -(-steps // fasttext_cls.GRAPH_CHUNK)  # chunk calls an epoch
    marks = []

    def fit(epochs):
        return fasttext_cls.FastTextClassifier(seed=seed, epochs=epochs, device="cuda",
                                               **kw).fit(texts, labels)

    with contextlib.nullcontext() if graphed else eager_fasttext():
        base = fasttext_cls.step_runner

        def marking(fn, device):
            inner, calls = base(fn, device), [0]

            def run(x, key=None):
                if calls[0] % chunks == 0:
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                calls[0] += 1
                return inner(x, key)
            return run

        fasttext_cls.step_runner = marking
        try:
            fit(3)
        finally:
            fasttext_cls.step_runner = base
        prof = []
        for epochs in (1, 2) if graphed else (1,):
            for _ in range(3):
                p = profile_breakdown(lambda: fit(epochs), batches=1)
                if isinstance(p.get("device_ms_per_batch"), float):
                    break
            prof.append(p)
    out = {"host_s": marks[2] - marks[1], "chunks_per_epoch": chunks,
           "profiled": "a 2-epoch fit less a 1-epoch fit" if graphed else "a 1-epoch fit"}
    if all(isinstance(p.get("device_ms_per_batch"), float) for p in prof):
        def epoch(get):
            return get(prof[-1]) - (get(prof[0]) if graphed else 0.0)

        out.update({
            "device_ms": epoch(lambda p: p["device_ms_per_batch"]),
            "device_ops": epoch(lambda p: p["kernels_per_batch"]),
            "host_launch_calls": epoch(lambda p: sum(p["host_calls_per_batch"].values())),
            "top_device_ops": prof[-1]["top"][:5]})
        out["idle"] = 1 - out["device_ms"] / 1e3 / out["host_s"]
    else:
        out.update(device_ms="not measured", device_ops="not measured",
                   host_launch_calls="not measured", idle="not measured")
    return out


def phase_eval(work: str, card: str) -> dict:
    """``eval-prepare`` and ``eval`` through the CLI on phase 6's ``.tsf``
    files; the lexicon's and the adversarial LR's fits with the C++ solver
    (eval-prepare's) against the Python one on the same matrices, with the
    NT of each; the card's fastText fit (its epochs CUDA graphs) against an
    eager fit on the card, bit for bit, and against a CPU fit from the same
    seed; a minibatch epoch's and a sequential example's cost, graphed
    beside eager. Phase 11's ``run`` drives the chain of stages."""
    import numpy as np
    import torch

    from consistent__style_transfer_torch import cli
    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.evaluate.content import (
        calculate_wmd_scores,
        mask_style_words,
        train_masked_word2vec,
    )
    from consistent__style_transfer_torch.evaluate.lexicon import (
        load_lexicon,
        load_model,
        load_train_set,
        ranked_lexicon,
    )
    from consistent__style_transfer_torch.evaluate.prepare import eval_paths, masked_w2v_texts
    from consistent__style_transfer_torch.evaluate.run_eval import run_eval
    from consistent__style_transfer_torch.text.native import default_threads
    from consistent__style_transfer_torch.utils.io import read_lines
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.text.fasttext_cls import GRAPH_CHUNK, FastTextClassifier

    t_phase = time.perf_counter()
    lap = laps("phase 7")
    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"), log_dir=os.path.join(work, "log"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("yelp", **dirs)
    p = eval_paths(cli._eval_dir(cfg), cfg.dataset, cfg.ver)
    check(all(os.path.exists(os.path.join(cfg.run_out_dir, f"style.{s}.{k}.tsf"))
              for s in ("train", "test") for k in (0, 1)), "phase 6's .tsf files are missing")

    def cli_run(argv):
        fused_decode_logits.launches = 0
        sinkhorn_cuda.launches = 0
        zero_lstm_launches()
        t0 = time.perf_counter()
        with watch_graphs() as made:
            lines = run_cli(argv)
        torch.cuda.synchronize()
        return (lines, time.perf_counter() - t0, fused_decode_logits.launches,
                sinkhorn_cuda.launches, made)

    # 1. eval-prepare: the classifier fit on the card (its epochs as CUDA
    # graphs), the lexicon, the masked word2vec and v0's adversarial LR
    lines, prepare_s, head, sink, made = cli_run(["eval-prepare", *flags])
    check(head == 0 and sink == 0, f"eval-prepare launched kernels: head {head}, Sinkhorn {sink}")
    lstm_launches("eval_prepare", 0)  # it scores the .tsf files: no generator
    timings, adv_printed = prepare_printed(lines)
    check(len(timings) == 1 and set(timings[0]) == {"classifier_s", "lexicon_s", "mask_s",
                                                     "mask_w2v_s", "adv_lr_s"},
          f"eval-prepare timings: {timings}")
    timings = timings[0]
    check(len(adv_printed) == 1 and adv_printed[0]["solver"] == "native",
          f"eval-prepare's adversarial LR: {adv_printed}")
    adv_printed = adv_printed[0]
    with np.load(p["classifier"]) as data:
        check(sorted(data.files) == ["emb", "meta", "out"], f"classifier keys {data.files}")
    model = FastTextClassifier.load_model(p["classifier"])
    check(model.emb.shape == (len(model.vocab) + 1, model.dim) and model.out.shape == (model.dim, 2)
          and np.isfinite(model.emb).all() and np.isfinite(model.out).all(),
          "classifier tables: shape or non-finite values")
    n_train = count_lines(cfg.train_files())
    want_meta = {"sgd_path": "minibatch", "n_examples": n_train, "batch_size": 64, "retries": 0}
    check(all(model.fit_meta.get(k) == v for k, v in want_meta.items()),
          f"fit_meta {model.fit_meta}, want {want_meta}")
    # the fit's epochs: chunks of GRAPH_CHUNK steps, each a replay but the
    # first call of each chunk shape
    steps = -(-n_train // 64)
    chunk_keys = [(64, k) for k in sorted({GRAPH_CHUNK, steps % GRAPH_CHUNK} - {0})]
    fit_graphs = check_replayed(made, chunk_keys, 5 * -(-steps // GRAPH_CHUNK),
                                "eval-prepare's classifier fit")
    dev_file, train_file = f"{p['tmp']}/{cfg.dataset}.dev", f"{p['tmp']}/{cfg.dataset}.train"
    n_dev, dev_p1, _ = model.test(dev_file)
    check(dev_p1 >= EVAL_P1_FLOOR, f"dev P@1 {dev_p1} below {EVAL_P1_FLOOR}")
    lexicon = load_lexicon(p["lexicon"])
    check(len(lexicon) > 0, "empty lexicon")
    check(os.path.exists(p["mask_w2v"]) and os.path.exists(p["adv_model"]),
          "masked word2vec or adversarial LR missing")
    check(len(load_model(p["vectorizer"]).vocabulary_) > 0, "empty vectorizer")

    lap("eval-prepare")

    # 2. eval through the CLI, then the unrounded scores from run_eval
    lines, eval_s, head, sink, _ = cli_run(["eval", *flags])
    check(head == 0 and sink == 0, f"eval launched kernels: head {head}, Sinkhorn {sink}")
    lstm_launches("eval", 0)
    scores = run_eval(cfg.ds_data_dir, cfg.run_out_dir, cli._eval_dir(cfg), cfg.dataset, cfg.ver,
                      quiet=True)
    printed = "\n".join(lines)
    for key, label, fmt in (("STI", "STI (higher is better)", "%.4f"),
                            ("CP", "CP (lower is better)", "%.4f"),
                            ("NT", "NT (higher is better)", "%.4f"),
                            ("ACC", "ACC (transfer accuracy)", "%.4f"),
                            ("selfBLEU", "self-BLEU", "%.2f"), ("refBLEU", "ref-BLEU", "%.2f")):
        check(key in scores and f"{label}: {fmt % scores[key]}" in printed,
              f"eval printed no {label} line equal to {scores.get(key)}")
    check(-1 <= scores["STI"] <= 1, f"STI {scores['STI']}")
    check(math.isfinite(scores["CP"]) and scores["CP"] >= 0, f"CP {scores['CP']}")
    check(0 <= scores["NT"] <= 1 and 0 <= scores["ACC"] <= 1, f"NT/ACC {scores}")
    check(math.isfinite(scores["selfBLEU"]) and math.isfinite(scores["refBLEU"]), f"BLEU {scores}")

    lap("eval")

    # 2b. eval's CP from the hogwild masked word2vec against the CP from a
    # one-thread one (a function of the seed alone: the JAX package's at one
    # thread) on the same masked corpus and pairs, within CP_REL_TOL
    t0 = time.perf_counter()
    single = train_masked_word2vec(masked_w2v_texts(cfg.ds_data_dir, lexicon),
                                   os.path.join(work, "mask_w2v_one_thread.npz"), seed=cfg.seed,
                                   n_threads=1)
    one_thread_s = time.perf_counter() - t0
    single.init_sims()
    origin = [line for k in (0, 1) for line in read_lines(f"{cfg.ds_data_dir}/style.test.{k}")]
    transfer = [line for k in (0, 1)
                for line in read_lines(f"{cfg.run_out_dir}/style.test.{k}.tsf")]
    wmd = [d for d in calculate_wmd_scores(mask_style_words(transfer, lexicon),
                                           mask_style_words(origin, lexicon), single)
           if math.isfinite(d)]
    cp_one_thread = sum(wmd) / max(len(wmd), 1)
    check(abs(scores["CP"] - cp_one_thread) <= CP_REL_TOL * cp_one_thread,
          f"CP {scores['CP']} (hogwild) against {cp_one_thread} (one thread): over "
          f"{CP_REL_TOL} relative")

    lap("the one-thread masked word2vec and its CP")

    # 2c. the lexicon's and v0's adversarial LR with both solvers on the same
    # matrices: the C++ fits are eval-prepare's (the same weights: the order
    # is a function of the seed), so their lexicon and NT are the artifacts'
    vectorizer = load_model(p["vectorizer"])
    x, y = load_train_set(*cfg.split_files("train"), seed=cfg.seed)
    lex_numbers, lex_fits = fit_both_solvers(vectorizer.transform(x), y, cfg.seed, "lexicon LR")
    check(lex_numbers["objective_rel_diff"] <= LR_OBJ_REL,
          f"lexicon LR: the C++ objective {lex_numbers['native']['objective']} above the "
          f"Python solver's {lex_numbers['python']['objective']} x (1 + {LR_OBJ_REL})")
    lexicons = {k: {w for w, _ in ranked_lexicon(lr.coef_[0], vectorizer.vocabulary_)}
                for k, lr in lex_fits.items()}
    check(lexicons["native"] == lexicon, "the C++ lexicon fit is not eval-prepare's")
    lex_numbers["lexicon_words"] = {k: len(v) for k, v in lexicons.items()}
    lex_numbers["lexicon_words_apart"] = len(lexicons["native"] ^ lexicons["python"])
    check(lex_numbers["lexicon_words_apart"] <= LEXICON_WORDS_TOL,
          f"lexicons: {sorted(lexicons['native'] - lexicons['python'])} C++ only, "
          f"{sorted(lexicons['python'] - lexicons['native'])} Python only")
    adv_numbers = adversarial_both_solvers(cfg, p, origin, transfer, "adversarial LR")
    check(adv_numbers["native"]["NT"] == scores["NT"],
          f"NT {adv_numbers['native']['NT']} from the C++ fit, eval's {scores['NT']}")
    check(adv_numbers["native"]["newton_iter"] == adv_printed["newton_iter"],
          f"the C++ adversarial fit: {adv_numbers['native']}, eval-prepare's {adv_printed}")
    print(json.dumps({"phase 7 L1 LR": {"card": card, "lexicon": lex_numbers,
                                        "adversarial": adv_numbers,
                                        "eval_prepare_adversarial": adv_printed}}), flush=True)

    lap("both L1 solvers on the lexicon's and the adversarial matrices")

    # 3. the card's graphed fit (eval-prepare's) against an eager one on the
    # card, bit for bit, and against the CPU's, from the same seed
    with eager_fasttext():
        eager = FastTextClassifier(seed=cfg.seed, device="cuda").fit_file(train_file)
    check(eager.fit_meta == model.fit_meta and np.array_equal(eager.emb, model.emb)
          and np.array_equal(eager.out, model.out),
          f"the graphed fit differs from the eager one: emb "
          f"{float(np.abs(eager.emb - model.emb).max())}, out "
          f"{float(np.abs(eager.out - model.out).max())}")
    t0 = time.perf_counter()
    cpu = FastTextClassifier(seed=cfg.seed, device="cpu").fit_file(train_file)
    cpu_fit_s = time.perf_counter() - t0
    _, cpu_p1, _ = cpu.test(dev_file)
    emb_err = float(np.abs(model.emb - cpu.emb).max())
    out_err = float(np.abs(model.out - cpu.out).max())
    check(cpu.fit_meta == model.fit_meta, f"fit_meta: card {model.fit_meta}, CPU {cpu.fit_meta}")
    check(abs(dev_p1 - cpu_p1) <= FASTTEXT_P1_TOL, f"dev P@1: card {dev_p1}, CPU {cpu_p1}")
    check(emb_err <= FASTTEXT_TABLE_TOL and out_err <= FASTTEXT_TABLE_TOL,
          f"card vs CPU tables: emb {emb_err}, out {out_err}")

    lap("the eager fit on the card and the CPU fit")

    # 4. a minibatch epoch (the eval-prepare fit's) and the sequential
    # path's epoch on 1,000 examples, each graphed beside eager
    with open(train_file, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t", 1) for line in f]
    labels, texts = [r[0] for r in rows], [r[1] for r in rows]
    epoch = {way: fasttext_epoch_cost(texts, labels, cfg.seed, way == "graphed")
             for way in ("graphed", "eager")}
    seq = {way: fasttext_epoch_cost(texts[::32], labels[::32], cfg.seed, way == "graphed",
                                    sgd="sequential") for way in ("graphed", "eager")}
    seq_n = len(texts[::32])
    for way, v in seq.items():
        v["ms_per_example"] = v["host_s"] * 1e3 / seq_n
        if isinstance(v["device_ms"], float):
            v["device_ms_per_example"] = v["device_ms"] / seq_n
            v["device_ops_per_example"] = v["device_ops"] / seq_n
    lap("the minibatch and sequential epochs, graphed and eager")
    fasttext = {
        "n_examples": n_train, "batch_size": 64, "steps_per_epoch": steps,
        "graph_chunk": GRAPH_CHUNK, "graphs": fit_graphs,
        "classifier_s": timings["classifier_s"],
        "minibatch_epoch": epoch, "sequential_examples": seq_n, "sequential_epoch": seq,
        "graphed_equals_eager": True,
        "card_dev_p1": dev_p1, "cpu_dev_p1": cpu_p1, "cpu_fit_s": cpu_fit_s,
        "emb_max_abs_err": emb_err, "out_max_abs_err": out_err,
        "emb_max_abs": float(np.abs(cpu.emb).max()), "out_max_abs": float(np.abs(cpu.out).max()),
    }
    print(json.dumps({"phase 7 fastText epoch": {"card": card, **fasttext}}), flush=True)

    result = {"card": card, "phase_s": time.perf_counter() - t_phase,
              "eval_prepare_s": prepare_s, "prepare_timings": timings,
              "mask_w2v": {"trainer": "native", "threads": default_threads(),
                           "mask_w2v_s": timings["mask_w2v_s"], "eval_prepare_s": prepare_s,
                           "numpy_trainer_s": NUMPY_TRAINER_S, "one_thread_s": one_thread_s,
                           "cp": scores["CP"], "cp_one_thread": cp_one_thread,
                           "cp_rel_diff": abs(scores["CP"] - cp_one_thread) / max(cp_one_thread, 1e-12),
                           "cp_rel_tol": CP_REL_TOL},
              "eval_s": eval_s, "dev_n": n_dev, "dev_p1": dev_p1, "dev_p1_floor": EVAL_P1_FLOOR,
              "fit_meta": model.fit_meta, "lexicon_words": len(lexicon), "scores": scores,
              "fasttext": fasttext, "lexicon_lr": lex_numbers, "adversarial_lr": adv_numbers}
    print(json.dumps({"eval": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 8
def phase_megastep(work: str, card: str, eager_steady: dict) -> dict:
    """The optimize stage with ``megastep_k`` (its fused step as CUDA
    graphs) at full yelp width, on phase 5's scorers and phase 6's warmup G:
    1. graph replays of both ``do_apply`` branches against eager
       ``fused_step`` from the same state, in float32 and under bf16
       autocast (dropout off, coins given), and in float32 with dropout on
       and the coins drawn (the parameters, the Adam states, the
       accumulator and the generator states saved after both captures and
       restored before each run);
    2. ``optimize --epochs 1 --megastep_k 8 --resume 1`` through the CLI,
       then the graphed step's steady state: ms per step (host clock),
       device ms, device operations, the host's launch calls and graph
       replays per step, idle share, peak memory, beside phase 6's eager
       step (``eager_steady``);
    3. ``infer`` from the G it keeps, through the decode head
       (tests/test_torch_resume.py holds the resume from that state)."""
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.train.checkpoint import StateCheckpointer
    from consistent__style_transfer_torch.train.common import get_corpus, get_tokenizer
    from consistent__style_transfer_torch.train.optimize import GraphedFusedStep
    from consistent__style_transfer_torch.train.state import newest_checkpoint
    from consistent__style_transfer_torch.utils.profiling import StepTimer

    t_phase = time.perf_counter()
    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"), log_dir=os.path.join(work, "log"))
    ver = "v_mega"
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)] + ["--ver", ver]
    cfg = make_config("yelp", ver=ver, **dirs)
    device = torch.device(cfg.device)
    tokenizer = get_tokenizer(cfg)
    V, L, B = len(tokenizer), cfg.max_len, cfg.batch_size
    corpus = get_corpus(cfg, "train", tokenizer)
    n_train = count_lines(cfg.train_files())

    def build(dtype: str = "bfloat16", dropout: bool = True):  # on phase 6's warmup G
        return build_optimize(make_config("yelp", ver=ver, dtype=dtype, **dirs), V, device,
                              dropout)

    def stream():
        return iter(DevicePrefetcher(make_batches(corpus, B, L, "optimize", shuffle=True, seed=1),
                                     device))

    # 1. replays against eager, from one state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = stream()
    try:
        fixed = [next(batches)[1] for _ in range(9)]
    finally:
        batches.close()
    g = torch.Generator().manual_seed(3)
    coins = [(torch.rand(L, generator=g) < 0.5).to(device) for _ in fixed]
    equality = {}
    for dtype in ("float32", "bfloat16"):
        runs = []
        for graphed in (False, True):
            models, steps, _, acc, gens = build(dtype=dtype, dropout=False)

            def params():
                return [p.detach().clone() for m in (models.generator, models.disc)
                        for p in m.parameters()]

            start = params()
            scale = torch.ones((), device=device)
            run = (GraphedFusedStep(steps.fused_step, acc, *gens, scale, given_coins=True)
                   if graphed else None)
            losses = []
            for i, (b, c) in enumerate(zip(fixed, coins)):
                do_apply = i % cfg.d_update_every == 0
                if graphed:
                    aux, d_loss = run(b, do_apply, c)
                else:
                    aux, d_loss = steps.fused_step(b, acc, do_apply, *gens, scale, c)
                losses.append(torch.stack([aux[k].float() for k in ("loss", "G", "STI", "CP",
                                                                     "BK")] + [d_loss.float()]))
            torch.cuda.synchronize()
            if graphed:
                check(sorted(run.graphs) == [False, True], "both branches were not captured")
            runs.append((torch.stack(losses), params(), start))
            del models, steps, acc, run
        (l0, p0, s0), (l1, p1, _) = runs
        tol = GRAPH_TOL[dtype]
        loss_rel = float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max())
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p1, p0)])
        move = torch.cat([(a - b).abs().flatten() for a, b in zip(p0, s0)])
        share = float(diff.mean() / move.mean().clamp_min(1e-30))
        equality[dtype] = {"steps": len(fixed), "apply_replays": 2, "accumulate_replays": 5,
                           "loss_max_rel_diff": loss_rel, "param_mean_abs_diff": float(diff.mean()),
                           "param_max_abs_diff": float(diff.max()),
                           "param_mean_abs_move": float(move.mean()), "param_share": share,
                           "finite": bool(torch.isfinite(l0).all()), "tolerance": tol}

    # 1b. float32, dropout on, coins drawn: after both captures, the state
    # (parameters, Adam states, accumulator) and the generator states are
    # saved; eager steps and replays each start from them, in place
    models, steps, opts, acc, gens = build(dtype="float32")
    scale = torch.ones((), device=device)
    run = GraphedFusedStep(steps.fused_step, acc, *gens, scale)
    run(fixed[0], True)
    run(fixed[1], False)
    check(sorted(run.graphs) == [False, True], "both branches were not captured")
    params = [p for m in (models.generator, models.disc) for p in m.parameters()]
    state = params + acc + [t for o in opts for st in o.adam.state.values()
                            for t in st.values() if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in state]
    saved_gens = [g.get_state() for g in gens]
    runs = []
    for graphed in (False, True):
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        for g, v in zip(gens, saved_gens):
            g.set_state(v)
        losses = []
        for i, b in enumerate(fixed):
            do_apply = i % cfg.d_update_every == 0
            aux, d_loss = run(b, do_apply) if graphed else steps.fused_step(b, acc, do_apply,
                                                                             *gens, scale)
            losses.append(torch.stack([aux[k].float() for k in ("loss", "G", "STI", "CP",
                                                                 "BK")] + [d_loss.float()]))
        torch.cuda.synchronize()
        runs.append((torch.stack(losses), [p.detach().clone() for p in params],
                     [a.clone() for a in acc], [g.get_state() for g in gens]))
    (l0, p0, a0, g0), (l1, p1, a1, g1) = runs
    tol = GRAPH_TOL["float32"]
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p1, p0)])
    move = torch.cat([(a - b).abs().flatten() for a, b in zip(p0, saved)])
    acc_diff = torch.cat([(a - b).abs().flatten() for a, b in zip(a1, a0)])
    acc_size = torch.cat([a.abs().flatten() for a in a0])
    equality["float32_dropout_drawn_coins"] = {
        "steps": len(fixed), "p_drop": cfg.p_drop,
        "loss_max_rel_diff": float(((l1 - l0).abs() / l0.abs().clamp_min(1e-6)).max()),
        "param_mean_abs_diff": float(diff.mean()), "param_max_abs_diff": float(diff.max()),
        "param_mean_abs_move": float(move.mean()),
        "param_share": float(diff.mean() / move.mean().clamp_min(1e-30)),
        "acc_share": float(acc_diff.mean() / acc_size.mean().clamp_min(1e-30)),
        "generator_states_equal": all(torch.equal(x, y) for x, y in zip(g0, g1)),
        "finite": bool(torch.isfinite(l0).all()), "tolerance": tol}
    del models, steps, opts, acc, run, state, saved
    print(json.dumps({"megastep_replay_vs_eager": equality}), flush=True)
    for dtype, e in equality.items():
        check(e["finite"], f"{dtype}: non-finite eager losses")
        check(e["loss_max_rel_diff"] <= e["tolerance"]["loss_rel"],
              f"{dtype}: replay losses {e['loss_max_rel_diff']} apart (relative)")
        check(e["param_share"] <= e["tolerance"]["param_share"],
              f"{dtype}: replay parameters {e['param_share']} of their move apart")
    e = equality["float32_dropout_drawn_coins"]
    check(e["acc_share"] <= e["tolerance"]["param_share"],
          f"dropout on: replay accumulator {e['acc_share']} of its size apart")
    check(e["generator_states_equal"], "dropout on: replays moved the generators otherwise")
    torch.backends.cuda.matmul.allow_tf32 = True

    # 2. one epoch through the CLI with megastep_k=8, writing the full state
    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0
    zero_lstm_launches()
    t0 = time.perf_counter()
    with watch_graphs() as made:
        run_cli(["optimize", *flags, "--epochs", "1", "--megastep_k", str(MEGASTEP_K),
                 "--resume", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    check(fused_decode_logits.launches == 0 and sinkhorn_cuda.launches == 0,
          "the graphed optimize launched a kernel of the port")
    events = read_events(cfg, f"optimize-{ver}")
    losses = check_finite_losses(events, ("G", "STI", "CP", "BK", "D", "loss", "val_loss"),
                                 "optimize --megastep_k")
    epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // B
    check(epoch["train_steps"] == want, f"megastep: {epoch['train_steps']} steps, want {want}")
    cli_cells = lstm_launches("optimize_megastep", None, fused_step_cells(cfg)[1] * want)
    check(cli_cells["forward"] > fused_step_cells(cfg)[0] * want,
          f"megastep: {cli_cells} LSTM cell launches, want the steps' and validation's")
    check(epoch["d_applies"] == math.ceil(want / cfg.d_update_every),
          f"megastep: D applied {epoch['d_applies']}")
    # its validation, whatever megastep_k groups: a graph through step_runner
    check(epoch["val_s"] > 0, f"megastep logged val_s {epoch.get('val_s')}")
    val_graphs = check_replayed(made, [None], -(-count_lines(cfg.split_files("dev")) // B),
                                "megastep validation")
    state_dir = os.path.join(cfg.ds_dump_dir, f"optimize-{ver}", "full_state")
    saved = StateCheckpointer(state_dir).restore()
    check(saved is not None and saved["epoch"] == 0 and saved["step"] == want,
          "the full state of epoch 0 is missing")

    # steady state of the graphed step; phase 6 measured the eager one
    models, steps, _, acc, gens = build()
    runner = GraphedFusedStep(steps.fused_step, acc, *gens, torch.ones((), device=device))
    state = {"i": 0}
    batches = stream()
    timer = StepTimer()

    def step():
        with timer:
            out = runner(next(batches)[1], state["i"] % cfg.d_update_every == 0)
        state["i"] += 1
        return out

    try:
        graphed = steady_step(step)
        aux, d_loss = step()
        check(all(math.isfinite(v.item()) for v in (*aux.values(), d_loss)),
              "non-finite graphed losses")
    finally:
        batches.close()
    calls = graphed["host_calls_per_step"]
    if isinstance(calls, dict):
        graphed["graph_replays_per_step"] = calls.get("cudaGraphLaunch", 0.0)
        graphed["kernel_launches_per_step_host"] = sum(
            v for k, v in calls.items() if "LaunchKernel" in k)
    graphed["captured_branches"] = sorted(runner.graphs)
    graphed["lstm_cell_launches_per_replay"] = {
        str(k): lstm_launches(f"optimize_megastep_graph_{k}", *fused_step_cells(cfg),
                              counts=replayed_cells(runner, k)) for k in runner.graphs}
    graphed["enqueue_ms_per_step"] = {k: v for k, v in timer.summary().items() if k != "steps"}
    del models, steps, acc, runner
    check(graphed["ms_per_step_steady"] > 0, "no graphed step time")

    # 3. infer from the G the run keeps
    best = newest_checkpoint(os.path.join(cfg.ds_dump_dir, f"optimize-{ver}"))
    check(best is not None and os.path.basename(best).startswith("G_epoch_"), f"best G {best}")
    fused_decode_logits.launches = 0
    zero_lstm_launches()
    t0 = time.perf_counter()
    run_cli(["infer", *flags])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_launches = fused_decode_logits.launches
    infer_batches = sum(-(-count_lines(cfg.split_files(s)) // B) for s in ("train", "test"))
    check(infer_launches == L * infer_batches > 0,
          f"infer after megastep: {infer_launches} decode-head launches, want {L} x {infer_batches}")
    infer_cells = lstm_launches("infer_after_megastep", greedy_cells(infer_launches))

    result = {"card": card, "phase_s": time.perf_counter() - t_phase, "V": V, "L": L, "B": B,
              "dtype": "bfloat16 autocast, float32 parameters", "megastep_k": MEGASTEP_K,
              "replay_vs_eager": equality,
              "cli": {"s": cli_s, "train_steps": epoch["train_steps"],
                      "d_applies": epoch["d_applies"],
                      "ms_per_step_epoch": epoch["train_s"] * 1e3 / epoch["train_steps"],
                      "val_s": epoch["val_s"], "validation_graphs": val_graphs,
                      "losses": losses, "lstm_cell_launches": cli_cells},
              "steady": {**graphed, "eager": eager_steady,
                         "speedup_host": eager_steady["ms_per_step_steady"]
                         / graphed["ms_per_step_steady"]},
              "infer": {"s": infer_s, "batches": infer_batches,
                        "decode_head_launches": infer_launches,
                        "lstm_cell_launches": infer_cells}}
    print(json.dumps({"megastep": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 9
def cut_corpus(src, dst, keep: dict = CUT_LINES) -> None:
    """The first ``keep[split]`` lines (all of them where None) of each of
    config ``src``'s split files, a style, written to config ``dst``'s data
    dir; the human references, where ``src`` has them, copied whole."""
    os.makedirs(dst.ds_data_dir)
    for split, n in keep.items():
        for a, b in zip(src.split_files(split), dst.split_files(split)):
            with open(a, encoding="utf-8") as f:
                lines = f.readlines()
            with open(b, "w", encoding="utf-8") as f:
                f.writelines(lines[:n])
    for k in (0, 1):
        ref = os.path.join(src.ds_data_dir, f"reference.{k}")
        if os.path.exists(ref):
            shutil.copy(ref, dst.ds_data_dir)


def beam_graphed_vs_eager(model, x, labels, K: int) -> dict:
    """The beam of ``model`` in float32 through ``make_transfer_step``'s
    runner (the eager first call and the capture, then a replay) against
    ``beam_decode_any`` on the same batch: ids and scores equal."""
    import torch

    from consistent__style_transfer_torch.models.beam import beam_decode_any
    from consistent__style_transfer_torch.train.infer import make_transfer_step

    step = make_transfer_step(model, K)
    for _ in range(2):
        ids, scores = (t.clone() for t in step.runner({"x": x, "labels": labels},
                                                      tuple(x.shape)))
    want_ids, want_scores = beam_decode_any(model, x, labels, 1 - labels, beam_size=K)
    check(step.runner.replays == 1, f"beam: {step.runner.replays} replays, want 1")
    check(torch.equal(ids, want_ids), "float32 beam: graphed ids differ from eager ones")
    check(torch.equal(scores, want_scores), "float32 beam: graphed scores differ from eager ones")
    return {"B": x.shape[0], "beam_size": K, "dtype": "float32", "replays": 1,
            "ids_equal": True, "scores_equal": True}


def phase_beam_and_transformer(work: str, card: str, greedy_full: dict) -> dict:
    """Beam decode and the transformer backbone at full width:
    1. the LSTM's stateful beam (K=4) at the yelp serving shape (V=10000,
       L=18, B=256, bf16, seeded weights): ms per batch and sentences/s
       beside greedy on the same batch in the same call (and phase 4's
       ``greedy_full``), device ms and idle share; the card's float32 beam
       ids and scores against the CPU's on a few sentences; then ``serve``
       and ``infer`` with ``--beam_size 4`` through the CLI on phase 6's G;
    2. the transformer (T5-small widths, float32 compute), its CLI
       commands on the first CUT_LINES lines of each yelp split file (a cut
       of depth), on phase 3's BPE dump and phase 5's scorers: ``warmup
       --backbone transformer`` (one epoch, B=512), ``optimize --backbone
       transformer --epochs 1`` (B=256, the graphed fused step), ``infer``
       greedy through the CLI, and the beam of 4 on the test split: the
       checkpoints load strictly, the losses are finite, one step a batch,
       D applied ceil(steps / 4) times; graph replays against eager steps
       in float32 from one saved state (dropout on, generators restored);
       the steady warmup and optimize steps (eager, and the optimize step
       graphed) with device ms, device operations, idle share and peak
       memory; greedy and beam-4 rates on a batch; the card's greedy ids
       against the CPU's on a few sentences.
    The decode head launches 0 times in all of it, the Sinkhorn too."""
    import torch

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.noise import align
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models.beam import beam_decode_any
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.models.seq2seq_transformer import TransformerSeq2Seq
    from consistent__style_transfer_torch.train.common import (
        build_generator,
        generator_call,
        get_corpus,
        get_tokenizer,
    )
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.infer import make_transfer_step, transfer_split
    from consistent__style_transfer_torch.train.optimize import load_generator_params
    from consistent__style_transfer_torch.train.state import AdamWithClip
    from consistent__style_transfer_torch.train.warmup import WARMUP_INPUTS, make_warmup_steps

    t_phase = time.perf_counter()
    lap = laps("phase 9")
    # phase 8 leaves TF32 on; a fresh process, as a user's CLI run, has it off
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(make_config("yelp").device)
    K = BEAM_K
    result = {"card": card, "beam_size": K, "length_penalty": 0.6}

    def zero_counts():
        fused_decode_logits.launches = 0
        sinkhorn_cuda.launches = 0
        zero_lstm_launches()

    def no_kernel(what, cells=0):
        """Neither the decode head nor the Sinkhorn launched since
        zero_counts, and the fused LSTM cell ``cells`` times forward, never
        backward."""
        check(fused_decode_logits.launches == 0, f"{what} launched the decode head "
              f"{fused_decode_logits.launches} times")
        check(sinkhorn_cuda.launches == 0, f"{what} launched the Sinkhorn")
        lstm_launches(what, cells)

    def batch_rate(step, x, labels, n, what, cells):
        for _ in range(2):
            step(x, labels)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            ids = step(x, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        launches = fused_decode_logits.launches
        lstm = lstm_launches(what, cells)
        prof = profile_breakdown(lambda: step(x, labels), batches=1)
        device_ms = prof.get("device_ms_per_batch")
        return ids, launches, {
            "ms_per_batch": ms, "sent_per_s": x.shape[0] * 1e3 / ms,
            "lstm_cell_launches_per_batch": lstm["forward"] / n,
            "device_ms_per_batch": device_ms,
            "device_ops_per_batch": prof.get("kernels_per_batch", "not measured"),
            "host_calls_per_batch": prof.get("host_calls_per_batch", "not measured"),
            "device_idle_share": (1 - device_ms / ms) if isinstance(device_ms, float)
            else "not measured",
            "top_device_ops": prof.get("top", ["not measured"])[:5],
            **peak_memory(lambda: step(x, labels))}

    # 1a. the LSTM beam at the yelp serving shape, beside greedy
    lstm = DenoiseSeq2Seq(n_vocab=YELP_V, n_class=2, max_len=YELP_L, seed=0)
    lstm = lstm.to(device, torch.bfloat16).eval()
    g = torch.Generator().manual_seed(1)
    x = torch.randint(3, YELP_V, (YELP_B, YELP_L), generator=g, dtype=torch.int32).to(device)
    labels = torch.randint(0, 2, (YELP_B,), generator=g, dtype=torch.int32).to(device)
    ids, greedy_launches, greedy = batch_rate(make_transfer_step(lstm), x, labels, 10,
                                             "serving_greedy_beside_beam", 3 * YELP_L * 10)
    check(greedy_launches == YELP_L * 10, f"greedy: {greedy_launches} decode-head launches")
    result["greedy_beside_beam_launches"] = greedy_launches
    # the beam as the transfer step runs it (a CUDA graph replay), beside
    # the eager beam on the same batch
    beam_step = make_transfer_step(lstm, K)
    ids, beam_launches, beam = batch_rate(beam_step, x, labels, 10, "serving_beam",
                                         3 * YELP_L * 10)
    check(beam_launches == 0, f"the LSTM beam launched the decode head {beam_launches} times")
    check(ids.shape == (YELP_B, YELP_L) and ids.dtype == torch.int32
          and bool(((ids >= 0) & (ids < YELP_V)).all()), "LSTM beam ids shape/range")
    check(beam_step.runner.replays >= 10, "the LSTM beam did not replay its graph")
    beam["graph_nodes"] = graph_nodes(beam_step.runner.graphs[tuple(x.shape)])

    def eager_beam(x, labels):
        return beam_decode_any(lstm, x, labels, 1 - labels, beam_size=K)[0]

    _, eager_launches, beam_eager = batch_rate(eager_beam, x, labels, 10, "serving_beam_eager",
                                                3 * YELP_L * 10)
    check(eager_launches == 0, "the eager LSTM beam launched the decode head")
    apart = float((beam_step(x, labels) != eager_beam(x, labels)).float().mean())
    check(apart <= BF16_TOKEN_SHARE, f"bf16 LSTM beam: graphed ids {apart} apart from eager")
    result["lstm_yelp_shape"] = {
        "V": YELP_V, "L": YELP_L, "B": YELP_B, "dtype": "bfloat16", "beam": beam,
        "beam_eager": beam_eager, "beam_graphed_vs_eager_token_share": apart,
        "beam_speedup_host": beam_eager["ms_per_batch"] / beam["ms_per_batch"],
        "greedy_same_call": greedy, "greedy_phase_4_ms_per_batch": greedy_full["ms_per_batch"],
        "beam_over_greedy_ms": beam["ms_per_batch"] / greedy["ms_per_batch"]}
    del beam_step

    # 1b. float32 beam, card against CPU, a few sentences
    f32 = DenoiseSeq2Seq(n_vocab=YELP_V, n_class=2, max_len=YELP_L, seed=0).eval()
    xs, ls = x[:BEAM_CHECK_N].cpu(), labels[:BEAM_CHECK_N].cpu()
    cpu_ids, cpu_scores = beam_decode_any(f32, xs, ls, 1 - ls, beam_size=K)
    f32 = f32.to(device)
    xd, ld = xs.to(device), ls.to(device)
    card_ids, card_scores = (t.cpu() for t in beam_decode_any(f32, xd, ld, 1 - ld, beam_size=K))
    score_err = float((card_scores - cpu_scores).abs().max())
    check(torch.equal(card_ids, cpu_ids), "f32 LSTM beam ids on the card differ from the CPU's")
    check(score_err <= BEAM_SCORE_TOL, f"f32 LSTM beam scores {score_err} apart")
    result["lstm_f32_card_vs_cpu"] = {"sentences": BEAM_CHECK_N, "ids_equal": True,
                                      "score_max_abs_diff": score_err, "tolerance": BEAM_SCORE_TOL}
    # float32 at the full batch: graph replays against the eager beam
    result["lstm_f32_graphed_vs_eager"] = beam_graphed_vs_eager(f32, x, labels, K)
    del lstm, f32

    lap("the LSTM beam at the serving shape")
    # 1c. serve and infer --beam_size 4 through the CLI on phase 6's G
    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output_beam"), log_dir=os.path.join(work, "log_tf"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("yelp", **dirs)
    tokenizer = get_tokenizer(cfg)
    V, L = len(tokenizer), cfg.max_len
    requests = []
    for label in (0, 1):
        with open(os.path.join(cfg.ds_data_dir, f"style.test.{label}"), encoding="utf-8") as f:
            requests += [f"{label}\t{line.strip()}" for line in f if line.strip()]
    zero_counts()
    t0 = time.perf_counter()
    served = run_cli(["serve", *flags, "--beam_size", str(K)], "\n".join(requests) + "\n")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    # the beam: the encoder once and L decoder cells over the K beams' rows,
    # 3 x L cells a batch
    no_kernel("serve_beam", 3 * L * -(-len(requests) // cfg.batch_size))
    check(len(served) == len(requests), f"beam serve printed {len(served)} of {len(requests)}")
    zero_counts()
    t0 = time.perf_counter()
    run_cli(["infer", *flags, "--beam_size", str(K)])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    no_kernel("infer_beam", 3 * L * sum(-(-count_lines(cfg.split_files(s)) // cfg.batch_size)
                                        for s in ("train", "test")))
    n_infer = 0
    for split in ("train", "test"):
        for label in (0, 1):
            want = count_lines([os.path.join(cfg.ds_data_dir, f"style.{split}.{label}")])
            with open(os.path.join(cfg.run_out_dir, f"style.{split}.{label}.tsf"),
                      encoding="utf-8") as f:
                got = len(f.read().splitlines())
            check(got == want, f"beam infer {split}.{label}: {got} lines, want {want}")
            n_infer += want
    result["lstm_cli"] = {"serve_requests": len(requests), "serve_s": serve_s,
                          "serve_sent_per_s": len(requests) / serve_s,
                          "infer_sentences": n_infer, "infer_s": infer_s,
                          "infer_sent_per_s": n_infer / infer_s, "decode_head_launches": 0}
    print(json.dumps({"beam_lstm": result}), flush=True)

    lap("serve and infer with the beam")
    # 2. the transformer backbone, its CLI commands on the cut corpus
    ver = "v_tf"
    tdirs = dict(dirs, data_dir=os.path.join(work, "tf_data"))
    tf_flags = [a for k, v in tdirs.items() for a in (f"--{k}", v)] + [
        "--backbone", "transformer", "--ver", ver]
    tcfg = make_config("yelp", backbone="transformer", ver=ver, **tdirs)
    cut_corpus(cfg, tcfg)
    n_train = count_lines(tcfg.train_files())

    def load_strict(path):
        check(os.path.exists(path), f"missing {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        TransformerSeq2Seq(V, tcfg.n_class, L).load_state_dict(sd, strict=True)
        check(all(bool(torch.isfinite(v).all()) for v in sd.values()), f"{path}: non-finite")

    def cli_timed(argv, made=None):
        zero_counts()
        t0 = time.perf_counter()
        with watch_graphs() as graphed:
            run_cli(argv)
        torch.cuda.synchronize()
        no_kernel(f"{argv[0]}_transformer")
        if made is not None:
            made[:] = graphed
        return time.perf_counter() - t0

    made = []
    warm_s = cli_timed(["warmup", *tf_flags], made)
    warm_path = os.path.join(tcfg.ds_dump_dir, "warmup", "G_transformer.pth")
    load_strict(warm_path)
    check(os.path.exists(os.path.join(tcfg.ds_dump_dir, "warmup", "G.pth")),
          "phase 6's LSTM G.pth is gone")
    events = read_events(tcfg, "warmup")
    warm_losses = check_finite_losses(events, ("dn_loss", "val_loss"), "transformer warmup")
    warm_epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // tcfg.warmup_batch_size
    check(warm_epoch["train_steps"] == want, f"transformer warmup: {warm_epoch['train_steps']}")
    warm_graphs = check_replayed(made, [None], want, "transformer warmup", steps=2)
    warm_val_graphs = check_replayed(made, [None], -(-count_lines(tcfg.split_files("dev"))
                                                    // tcfg.warmup_batch_size),
                                     "transformer warmup validation", steps=2, index=1)

    opt_s = cli_timed(["optimize", *tf_flags, "--epochs", "1"])
    task = os.path.join(tcfg.ds_dump_dir, f"optimize-{ver}")
    load_strict(os.path.join(task, "G_epoch_0.pth"))
    events = read_events(tcfg, f"optimize-{ver}")
    opt_losses = check_finite_losses(events, ("G", "STI", "CP", "BK", "D", "loss", "val_loss"),
                                     "transformer optimize")
    opt_epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // tcfg.batch_size
    check(opt_epoch["train_steps"] == want, f"transformer optimize: {opt_epoch['train_steps']}")
    check(opt_epoch["d_applies"] == math.ceil(want / tcfg.d_update_every),
          f"transformer optimize: D applied {opt_epoch['d_applies']}")

    infer_s = cli_timed(["infer", *tf_flags], made)
    n_infer = sum(count_lines(tcfg.split_files(s)) for s in ("train", "test"))
    infer_graphs = check_replayed(
        made, [(tcfg.batch_size, L)],
        sum(-(-count_lines(tcfg.split_files(s)) // tcfg.batch_size) for s in ("train", "test")),
        "transformer infer")
    for split in ("train", "test"):
        for label in (0, 1):
            path = os.path.join(tcfg.run_out_dir, f"style.{split}.{label}.tsf")
            check(os.path.exists(path), f"missing {path}")

    lap("the transformer's warmup, optimize and infer commands")
    # beam 4 on the test split, the trained G
    bcfg = make_config("yelp", backbone="transformer", ver=ver, beam_size=K, mode="test", **dirs)
    model = build_generator(bcfg, V, device)
    load_generator_params(bcfg, model)
    zero_counts()
    t0 = time.perf_counter()
    routed = transfer_split(bcfg, model, tokenizer, "test")
    torch.cuda.synchronize()
    beam_test_s = time.perf_counter() - t0
    no_kernel("transformer_beam_test_split")
    n_test = count_lines(bcfg.split_files("test"))
    check(len(routed[0]) + len(routed[1]) == n_test, "transformer beam: lines missing")

    # greedy and beam rates on one batch, and the card against the CPU
    corpus = get_corpus(tcfg, "test", tokenizer)
    batch = next(iter(make_batches(corpus, tcfg.batch_size, L, "optimize", shuffle=False,
                                   seed=0)))
    bx = torch.from_numpy(batch["x"]).to(device)
    bl = torch.from_numpy(batch["labels"]).to(device)
    graphed_greedy = make_transfer_step(model)

    @torch.inference_mode()
    def eager_greedy(x, labels):
        return generator_call(model, x, labels, None, 1 - labels, mode="greedy")

    _, _, tf_greedy = batch_rate(graphed_greedy, bx, bl, 5, "transformer_greedy", 0)
    tf_greedy["graph_nodes"] = graph_nodes(graphed_greedy.runner.graphs[tuple(bx.shape)])
    _, _, tf_greedy_eager = batch_rate(eager_greedy, bx, bl, 5, "transformer_greedy_eager", 0)
    check(torch.equal(graphed_greedy(bx, bl), eager_greedy(bx, bl)),
          "transformer graphed greedy ids differ from eager ones")
    tf_beam_step = make_transfer_step(model, K)
    _, _, tf_beam = batch_rate(tf_beam_step, bx, bl, 2, "transformer_beam", 0)
    tf_beam["graph_nodes"] = graph_nodes(tf_beam_step.runner.graphs[tuple(bx.shape)])
    del tf_beam_step
    _, _, tf_beam_eager = batch_rate(
        lambda x, labels: beam_decode_any(model, x, labels, 1 - labels, beam_size=K)[0],
        bx, bl, 1, "transformer_beam_eager", 0)
    tf_beam_replay = beam_graphed_vs_eager(model, bx, bl, K)
    check(fused_decode_logits.launches == 0, "the transformer launched the decode head")
    enc = [tokenizer.encode(r.split("\t", 1)[1])[:L] for r in requests[::125]]
    xs, _ = align(enc, 0, L)
    xs = torch.from_numpy(xs)
    ls = torch.tensor([int(r[0]) for r in requests[::125]], dtype=torch.int32)
    card_step = make_transfer_step(model)
    for _ in range(2):  # the eager first call, then a replay
        card = card_step(xs.to(device), ls.to(device)).cpu()
    card_beam = [t.cpu() for t in beam_decode_any(model, xs[:2].to(device), ls[:2].to(device),
                                                  1 - ls[:2].to(device), beam_size=K)]
    cpu_model = build_generator(make_config("yelp", backbone="transformer", device="cpu"), V,
                                torch.device("cpu"))
    cpu_model.load_state_dict(model.state_dict())
    cpu = make_transfer_step(cpu_model)(xs, ls)
    cpu_beam = beam_decode_any(cpu_model, xs[:2], ls[:2], 1 - ls[:2], beam_size=K)
    check(torch.equal(card, cpu), "transformer greedy ids on the card differ from the CPU's")
    check(torch.equal(card_beam[0], cpu_beam[0]), "transformer beam ids differ from the CPU's")
    tf_score_err = float((card_beam[1] - cpu_beam[1]).abs().max())
    check(tf_score_err <= BEAM_SCORE_TOL, f"transformer beam scores {tf_score_err} apart")
    del model, cpu_model

    lap("the transformer's beam and greedy batches, card against CPU")
    # graph replays against eager steps, float32, dropout on, from one state
    def opt_cfg(dtype):  # on the transformer's warmup G
        return make_config("yelp", backbone="transformer", ver=ver, dtype=dtype, **dirs)

    train_corpus = get_corpus(make_config("yelp", **dirs), "train", tokenizer)

    def stream(stage, batch_size):
        return iter(DevicePrefetcher(make_batches(train_corpus, batch_size, L, stage,
                                                  shuffle=True, seed=1), device))

    batches = stream("optimize", tcfg.batch_size)
    try:
        fixed = [next(batches)[1] for _ in range(TF_REPLAY_STEPS + 2)]
    finally:
        batches.close()
    replay = optimize_replays(opt_cfg("float32"), V, device, fixed, "transformer")
    del fixed

    lap("the transformer's optimize replays")
    # steady steps at the CLI's settings (bf16 autocast for the scorers)
    model = build_generator(tcfg, V, device, training=True)
    model.load_state_dict(torch.load(warm_path, map_location=device, weights_only=True))
    warm_step, _ = make_warmup_steps(model, AdamWithClip(model.parameters(), tcfg.warmup_lr,
                                                         tcfg.warmup_clip), torch.bfloat16)
    gen = torch.Generator(device).manual_seed(1)
    batches = stream("warmup", tcfg.warmup_batch_size)
    runner = GraphedStep(lambda inputs, _: warm_step(inputs, gen), (gen,))

    def graphed_warm():
        arrays = next(batches)[1]
        return runner({k: arrays[k] for k in WARMUP_INPUTS})

    try:
        warm_steady = steady_step(lambda: warm_step(next(batches)[1], gen), batches=10)
        warm_graphed = steady_step(graphed_warm, batches=10)
        check(math.isfinite(graphed_warm().item()), "non-finite graphed transformer warmup loss")
    finally:
        batches.close()
    warm_graphed["graph_nodes"] = graph_nodes(runner.graphs[None])
    del model, warm_step, runner
    warm_replay = warmup_replays(tcfg, V, device, warm_path, train_corpus)
    print(json.dumps({"transformer_warmup_replay_vs_eager": warm_replay}), flush=True)
    check_replays(warm_replay, "transformer warmup")

    # the graphed step only: the eager one (about 620 ms a step on an NVIDIA
    # H100 80GB HBM3, PERF.md) is held against the replays above, not timed
    models, steps, _, acc, gens = build_optimize(opt_cfg("bfloat16"), V, device)
    opt_graphed = optimize_steady(steps, acc, gens, tcfg.d_update_every,
                                  stream("optimize", tcfg.batch_size), cells=(0, 0),
                                  what="optimize_transformer")
    no_kernel("transformer_steady_steps")
    del models, steps, acc
    lap("the transformer's steady steps and warmup replays")

    result["transformer"] = {
        "V": V, "L": L, "widths": "T5-small: d=512, 8 heads, 6+6 layers, ff 2048",
        "compute": "float32 (its parameters and products; the scorers bf16 autocast)",
        "train_sentences": n_train,
        "warmup": {"cli_s": warm_s, "train_steps": warm_epoch["train_steps"],
                   "batch_size": tcfg.warmup_batch_size,
                   "ms_per_step_epoch_graphed": warm_epoch["train_s"] * 1e3
                   / warm_epoch["train_steps"],
                   "losses": warm_losses, **warm_steady, "graphed": warm_graphed,
                   "speedup_host": warm_steady["ms_per_step_steady"]
                   / warm_graphed["ms_per_step_steady"],
                   "cli_graphs": warm_graphs, "replay_vs_eager": warm_replay,
                   "val_s": warm_epoch["val_s"], "cli_validation_graphs": warm_val_graphs},
        "optimize": {"cli_s": opt_s, "train_steps": opt_epoch["train_steps"],
                     "d_applies": opt_epoch["d_applies"], "batch_size": tcfg.batch_size,
                     "ms_per_step_epoch_graphed": opt_epoch["train_s"] * 1e3
                     / opt_epoch["train_steps"],
                     "losses": opt_losses, "graphed": opt_graphed},
        "replay_vs_eager": replay,
        "infer_greedy": {"s": infer_s, "sentences": n_infer, "sent_per_s": n_infer / infer_s,
                         "graphs": infer_graphs},
        "beam_test_split": {"s": beam_test_s, "sentences": n_test,
                            "sent_per_s": n_test / beam_test_s},
        "greedy_batch": tf_greedy, "greedy_batch_eager": tf_greedy_eager,
        "greedy_speedup_host": tf_greedy_eager["ms_per_batch"] / tf_greedy["ms_per_batch"],
        "beam_batch": tf_beam, "beam_batch_eager": tf_beam_eager,
        "beam_speedup_host": tf_beam_eager["ms_per_batch"] / tf_beam["ms_per_batch"],
        "beam_graphed_vs_eager": tf_beam_replay,
        "f32_card_vs_cpu": {"greedy_sentences": len(enc), "beam_sentences": 2,
                            "ids_equal": True, "beam_score_max_abs_diff": tf_score_err},
        "decode_head_launches": 0}
    result["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"beam_transformer": result["transformer"], "phase_9_s": result["phase_s"]}),
          flush=True)
    return result


# ------------------------------------------------------------------ phase 10
LAUNCHER_STEPS = 9  # graphed optimize steps a side: D applies at 0, 4 and 8
PRE_WARM_STEPS = 3  # warmup and pretrain steps a side


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_tensors(modules, opts, acc=()) -> list:
    """Parameters, every Adam state tensor and the accumulator, in a fixed
    order, copied."""
    out = [p.detach().clone() for m in modules for p in m.parameters()]
    out += [t.detach().clone() for o in opts for st in o.adam.state.values()
            for t in st.values() if hasattr(t, "detach")]
    return out + [a.clone() for a in acc]


def phase_launcher(work: str, card: str) -> dict:
    """Data parallelism (``parallel/``) on the card, at world size 1 (one
    card; NCCL refuses two ranks on one GPU, so this is no multi-GPU
    measurement):
    1. in this process, a world-size-1 NCCL group: LAUNCHER_STEPS graphed
       optimize steps at full yelp width (phase 6's scorers and warmup G,
       float32) with the group's optimizers equal the same steps without
       the group bit for bit (losses, parameters, both Adam states, the
       accumulator, the generators), with dropout off and coins given and
       with dropout on and coins drawn, and the graphs' node counts each
       way; PRE_WARM_STEPS warmup steps (B=512) and pretrain steps (the
       three full-width towers, labels from the Sinkhorn) the same way; the
       graphed bf16 step's steady ms, device ms, device operations and idle
       share with and without the group, in this run;
    2. ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
       consistent__style_transfer_torch`` ``pretrain``, ``warmup``,
       ``optimize`` (one epoch each) and ``infer`` in a fresh dump dir (phase
       3's BPE and phase 5's word2vec copied in) on the first CUT_LINES
       lines of each yelp split file: finite logged losses, one step a
       batch, D's cadence, the child's own Sinkhorn launches (one a labeled
       batch) and decode-head launches (18 a batch) from its
       ``TPUST_KERNEL_COUNTS`` line, and its ``.tsf`` files byte-equal to a
       plain ``infer`` of the same G in this process."""
    import torch
    import torch.distributed as dist

    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.parallel.mesh import destroy_distributed, make_mesh
    from consistent__style_transfer_torch.parallel.sharding import data_group
    from consistent__style_transfer_torch.train.common import (
        build_classifier,
        build_generator,
        build_lm,
        build_matcher,
        get_corpus,
        get_tokenizer,
        get_w2v,
    )
    from consistent__style_transfer_torch.train.optimize import GraphedFusedStep
    from consistent__style_transfer_torch.train.pretrain import TASKS, make_pretrain_steps
    from consistent__style_transfer_torch.train.state import AdamWithClip
    from consistent__style_transfer_torch.train.warmup import make_warmup_steps

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(work, "dump"),
                out_dir=os.path.join(work, "output"), log_dir=os.path.join(work, "log"))
    cfg = make_config("yelp", dtype="float32", **dirs)
    device = torch.device(cfg.device)
    tokenizer = get_tokenizer(cfg)
    V, L, B = len(tokenizer), cfg.max_len, cfg.batch_size
    corpus = get_corpus(cfg, "train", tokenizer)
    result = {"card": card, "world_size": 1, "note": "one card: no multi-GPU measurement"}

    def fixed(stage, batch_size, n, **kw):
        it = iter(DevicePrefetcher(make_batches(corpus, batch_size, L, stage, shuffle=True,
                                                seed=1, **kw), device))
        try:
            return [next(it)[1] for _ in range(n)]
        finally:
            it.close()

    def all_equal(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    # 1. in process, a world-size-1 NCCL group
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        group = data_group(make_mesh(1, 1, "cuda"))
        check(group is not None, "no data group in a world-size-1 NCCL group")
        batches = fixed("optimize", B, LAUNCHER_STEPS)
        g = torch.Generator().manual_seed(4)
        coins = [(torch.rand(L, generator=g) < 0.5).to(device) for _ in batches]

        def build(dtype, dropout, grp):  # on phase 6's warmup G
            models, steps, opts, acc, gens = build_optimize(
                make_config("yelp", dtype=dtype, **dirs), V, device, dropout, grp)
            runner = GraphedFusedStep(steps.fused_step, acc, *gens, torch.ones((), device=device),
                                      given_coins=not dropout)
            return models, opts, acc, gens, runner

        optimize_eq = {}
        for dropout in (False, True):
            runs = {}
            for name, grp in (("plain", None), ("group", group)):
                models, opts, acc, gens, runner = build("float32", dropout, grp)
                losses = []
                for i, (b, c) in enumerate(zip(batches, coins)):
                    aux, d_loss = runner(b, i % cfg.d_update_every == 0, None if dropout else c)
                    losses.append(torch.stack([aux["loss"], aux["BK"], d_loss]).clone())
                torch.cuda.synchronize()
                check(sorted(runner.graphs) == [False, True], "both branches were not captured")
                runs[name] = {"losses": torch.stack(losses),
                              "state": state_tensors((models.generator, models.disc), opts, acc),
                              "gens": [x.get_state() for x in gens],
                              "nodes": {str(k): graph_nodes(gr) for k, gr in runner.graphs.items()}}
                del models, opts, acc, gens, runner
            p, q = runs["plain"], runs["group"]
            optimize_eq["dropout_on_coins_drawn" if dropout else "dropout_off_coins_given"] = {
                "steps": LAUNCHER_STEPS, "finite": bool(torch.isfinite(p["losses"]).all()),
                "losses_equal": torch.equal(p["losses"], q["losses"]),
                "state_equal": all_equal(p["state"], q["state"]),
                "state_tensors": len(p["state"]),
                "generators_equal": all_equal(p["gens"], q["gens"]),
                "max_abs_diff": max(float((x - y).abs().max()) for x, y in
                                    zip(p["state"], q["state"])),
                "graph_nodes_plain": p["nodes"], "graph_nodes_group": q["nodes"]}
        result["optimize_group_vs_plain"] = optimize_eq

        # warmup steps, eager, dropout on and the coins drawn
        warm_batches = fixed("warmup", cfg.warmup_batch_size, PRE_WARM_STEPS)
        runs = {}
        for name, grp in (("plain", None), ("group", group)):
            model = build_generator(cfg, V, device, training=True)
            model.load_state_dict(torch.load(os.path.join(cfg.ds_dump_dir, "warmup", "G.pth"),
                                             map_location=device, weights_only=True), strict=True)
            opt = AdamWithClip(model.parameters(), cfg.warmup_lr, cfg.warmup_clip, group=grp)
            step, _ = make_warmup_steps(model, opt)
            gen = torch.Generator(device).manual_seed(5)
            losses = torch.stack([step(b, gen) for b in warm_batches])
            torch.cuda.synchronize()
            runs[name] = (losses, state_tensors((model,), (opt,)))
            del model, opt, step
        result["warmup_group_vs_plain"] = {
            "steps": PRE_WARM_STEPS, "batch_size": cfg.warmup_batch_size,
            "finite": bool(torch.isfinite(runs["plain"][0]).all()),
            "losses_equal": torch.equal(runs["plain"][0], runs["group"][0]),
            "state_equal": all_equal(runs["plain"][1], runs["group"][1])}

        # pretrain steps: the full-width towers, labels from the Sinkhorn
        labeler = SinkhornWmdLabeler(get_w2v(cfg, tokenizer), tokenizer,
                                     max_atoms=L + L // 2, device=device)
        pre_batches = fixed("pretrain", B, PRE_WARM_STEPS, wmd_labeler=labeler)
        runs = {}
        for name, grp in (("plain", None), ("group", group)):
            towers = {"cls": build_classifier(cfg, V, device), "mat": build_matcher(cfg, V, device),
                      "dn": build_lm(cfg, V, device)}
            for t in TASKS:
                towers[t].load_state_dict(torch.load(
                    os.path.join(cfg.ds_dump_dir, "pretrain", f"{t}.pth"), map_location=device,
                    weights_only=True), strict=True)
            opt = AdamWithClip([p for t in TASKS for p in towers[t].parameters()],
                               cfg.pretrain_lr, cfg.pretrain_clip, group=grp)
            step, _ = make_pretrain_steps(towers, opt)
            gen = torch.Generator(device).manual_seed(6)
            losses = torch.stack([torch.stack(list(step(b, (True, True, True), gen).values()))
                                  for b in pre_batches])
            torch.cuda.synchronize()
            runs[name] = (losses, state_tensors(towers.values(), (opt,)))
            del towers, opt, step
        result["pretrain_group_vs_plain"] = {
            "steps": PRE_WARM_STEPS, "batch_size": B,
            "finite": bool(torch.isfinite(runs["plain"][0]).all()),
            "losses_equal": torch.equal(runs["plain"][0], runs["group"][0]),
            "state_equal": all_equal(runs["plain"][1], runs["group"][1])}
        del runs

        # the graphed bf16 step (dropout on, as a user's run) with and without
        torch.backends.cuda.matmul.allow_tf32 = False
        steady = {}
        for name, grp in (("plain", None), ("group", group)):
            models, opts, acc, gens, runner = build("bfloat16", True, grp)
            state = {"i": 0}
            stream = iter(DevicePrefetcher(make_batches(corpus, B, L, "optimize", shuffle=True,
                                                        seed=2), device))

            def step():
                out = runner(next(stream)[1], state["i"] % cfg.d_update_every == 0)
                state["i"] += 1
                return out

            try:
                steady[name] = steady_step(step)
            finally:
                stream.close()
            steady[name]["graph_nodes"] = {str(k): graph_nodes(gr)
                                           for k, gr in runner.graphs.items()}
            del models, opts, acc, gens, runner
        result["steady_graphed_bf16"] = steady
    finally:
        destroy_distributed()
    log(f"phase 10: in process in {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"launcher_in_process": result}), flush=True)
    for case, e in result["optimize_group_vs_plain"].items():
        check(e["finite"], f"{case}: non-finite losses")
        check(e["losses_equal"] and e["state_equal"] and e["generators_equal"],
              f"{case}: graphed steps with the group differ from those without "
              f"(max abs diff {e['max_abs_diff']})")
        for branch, n in e["graph_nodes_group"].items():
            check(n > e["graph_nodes_plain"][branch],
                  f"{case}: the group's graph ({branch}) holds no more nodes")
    for key in ("warmup_group_vs_plain", "pretrain_group_vs_plain"):
        e = result[key]
        check(e["finite"] and e["losses_equal"] and e["state_equal"],
              f"{key}: steps with the group differ from those without: {e}")

    # 2. the commands under the launcher, in a fresh dump dir, on the first
    # CUT_LINES lines of each yelp split file (a cut of depth)
    fresh = dict(dirs, data_dir=os.path.join(work, "launch_data"),
                 dump_dir=os.path.join(work, "launch_dump"),
                 out_dir=os.path.join(work, "launch_output"),
                 log_dir=os.path.join(work, "launch_log"))
    lcfg = make_config("yelp", **fresh)
    cut_corpus(cfg, lcfg)
    os.makedirs(lcfg.ds_dump_dir)
    for path in (*cfg.vocab_paths, cfg.w2v_path):  # phase 3's BPE, phase 5's word2vec
        shutil.copy(path, lcfg.ds_dump_dir)
    flags = [a for k, v in fresh.items() for a in (f"--{k}", v)]
    n_train, n_dev = count_lines(lcfg.train_files()), count_lines(lcfg.split_files("dev"))
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m", "consistent__style_transfer_torch"]
    env = dict(os.environ, TPUST_KERNEL_COUNTS="1")
    runs = {}
    for command, extra in (("pretrain", ["--epochs", "1"]), ("warmup", []),
                           ("optimize", ["--epochs", "1"]), ("infer", [])):
        t0 = time.perf_counter()
        proc = subprocess.run([*launcher, command, *flags, *extra], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"launcher {command} exited {proc.returncode}: {proc.stderr[-3000:]}")
        reports = [json.loads(line)["kernel_launches"] for line in proc.stderr.splitlines()
                   if line.startswith('{"kernel_launches"')]
        check(len(reports) == 1 and reports[0]["rank"] == 0 and reports[0]["command"] == command,
              f"launcher {command}: kernel reports {reports}")
        runs[command] = {"wall_s": wall, "command_s": reports[0]["seconds"],
                         "decode_head_launches": reports[0]["fused_decode_logits"],
                         "sinkhorn_launches": reports[0]["sinkhorn"],
                         "lstm_cell_launches": (reports[0]["lstm_cell_fwd"],
                                                reports[0]["lstm_cell_bwd"])}
        log(f"phase 10: launcher {command} in {wall:.1f} s")
    labeled = n_train // B + -(-n_dev // B)
    r = runs["pretrain"]
    check(r["sinkhorn_launches"] == labeled and r["decode_head_launches"] == 0,
          f"launcher pretrain: {r}; want {labeled} Sinkhorn launches")
    events = read_events(lcfg, "pretrain")
    check(all(math.isfinite(v) for e in events for k, v in e.items()
              if k.endswith("_loss") or k.startswith("val_")), "launcher pretrain: a loss")
    epoch = [e for e in events if "train_steps" in e][-1]
    check(epoch["train_steps"] == n_train // B, f"launcher pretrain: {epoch['train_steps']} steps")
    r["train_steps"] = epoch["train_steps"]
    r["lstm_cell_launches"] = lstm_launches("pretrain_launcher", 0,
                                            counts=r["lstm_cell_launches"])
    for command in ("warmup", "optimize"):
        check(runs[command]["sinkhorn_launches"] == 0 and
              runs[command]["decode_head_launches"] == 0, f"launcher {command}: {runs[command]}")
    events = read_events(lcfg, "warmup")
    runs["warmup"]["losses"] = check_finite_losses(events, ("dn_loss", "val_loss"),
                                                   "launcher warmup")
    epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // lcfg.warmup_batch_size
    check(epoch["train_steps"] == want, f"launcher warmup: {epoch['train_steps']} steps")
    runs["warmup"]["train_steps"] = want
    runs["warmup"]["lstm_cell_launches"] = lstm_launches(
        "warmup_launcher", None, 3 * L * want * sum("train_steps" in e for e in events),
        counts=runs["warmup"]["lstm_cell_launches"])
    events = read_events(lcfg, f"optimize-{lcfg.ver}")
    runs["optimize"]["losses"] = check_finite_losses(
        events, ("G", "STI", "CP", "BK", "D", "loss", "val_loss"), "launcher optimize")
    epoch = [e for e in events if "train_steps" in e][-1]
    want = n_train // B
    check(epoch["train_steps"] == want
          and epoch["d_applies"] == math.ceil(want / lcfg.d_update_every),
          f"launcher optimize: {epoch['train_steps']} steps, {epoch['d_applies']} applies")
    runs["optimize"].update(train_steps=want, d_applies=epoch["d_applies"])
    cells = runs["optimize"]["lstm_cell_launches"] = lstm_launches(
        "optimize_launcher", None, fused_step_cells(lcfg)[1] * want,
        counts=runs["optimize"]["lstm_cell_launches"])
    check(cells["forward"] > fused_step_cells(lcfg)[0] * want,
          f"launcher optimize: {cells} LSTM cell launches, want the steps' and validation's")
    infer_batches = sum(-(-count_lines(lcfg.split_files(s)) // B) for s in ("train", "test"))
    r = runs["infer"]
    check(r["decode_head_launches"] == L * infer_batches and r["sinkhorn_launches"] == 0,
          f"launcher infer: {r}; want {L} x {infer_batches} decode-head launches")
    r["batches"] = infer_batches
    r["lstm_cell_launches"] = lstm_launches("infer_launcher", greedy_cells(L * infer_batches),
                                            counts=r["lstm_cell_launches"])

    # a plain infer of the same G (no launcher), byte for byte
    plain_out = os.path.join(work, "plain_output")
    t0 = time.perf_counter()
    run_cli(["infer", *[a for k, v in dict(fresh, out_dir=plain_out).items()
                        for a in (f"--{k}", v)]])
    torch.cuda.synchronize()
    plain_infer_s = time.perf_counter() - t0
    mine = os.path.join(lcfg.out_dir, f"yelp-{lcfg.ver}")
    theirs = os.path.join(plain_out, f"yelp-{lcfg.ver}")
    files = sorted(os.listdir(theirs))
    check(files == sorted(os.listdir(mine)) and len(files) == 4, f"tsf files {files}")
    for f in files:
        with open(os.path.join(mine, f), "rb") as a, open(os.path.join(theirs, f), "rb") as b:
            check(a.read() == b.read(), f"launcher infer: {f} differs from the plain infer's")
    r["tsf_byte_equal_plain"] = True
    r["plain_command_s"] = plain_infer_s
    result["launcher"] = runs
    result["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"launcher": result}), flush=True)
    return result


# ------------------------------------------------------------------ phase 11
def phase_full_run(work: str, card: str) -> dict:
    """The JAX package's 16k yelp smoke (``RESULTS.md:1103-1110``) end to end
    on the port, held to the JAX package's scores on that recipe under its
    default RNG (``RESULTS.md:315``, ``FULL_RUN_BAND``): on the committed
    yelp corpus, bf16, seed 0 and the port's defaults (equal to the JAX
    package's), in a fresh dump dir, ``pretrain`` (the preset's 10 epochs,
    patience 1), ``warmup --warmup_epochs 10``, then ``run`` (optimize, its
    10 epochs and patience 3, ``infer``, ``eval-prepare``, ``eval``). The
    BPE and the word2vec are phase 3's and phase 5's, which ``vocab`` and
    ``w2v`` write for this configuration; the eval runtime's classifier,
    lexicon and masked word2vec (functions of the corpus alone) are phase
    7's, so ``eval-prepare`` fits this version's adversarial LR. Checked:
    finite logged losses, the Sinkhorn once a labeled batch and the decode
    head 18 times a batch of the infer, every train step and dev batch a
    graph replay but the first of each branch, and the six scores inside
    the band. Printed: the epochs each stage ran, its epoch seconds after
    the first, its validation seconds (graphed), the prepare timings with
    ``adv_lr_s`` split (reading, transform, the C++ fit, its iterations)
    and the saved LR held to newGLMNET's stopping rule on its matrix, and
    the three validation passes, graphed against eager, on the trained
    weights in bf16."""
    import torch

    from consistent__style_transfer_torch import cli
    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.evaluate.prepare import eval_paths
    from consistent__style_transfer_torch.evaluate.run_eval import run_eval
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.train import optimize as optimize_stage
    from consistent__style_transfer_torch.train.common import get_tokenizer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # as a fresh process has it
    base = os.path.join(work, "full_run")
    dirs = dict(data_dir=os.path.join(ROOT, "data"), dump_dir=os.path.join(base, "dump"),
                out_dir=os.path.join(base, "output"), log_dir=os.path.join(base, "log"))
    flags = [a for k, v in dirs.items() for a in (f"--{k}", v)] + ["--ver", FULL_RUN_VER]
    cfg = make_config("yelp", ver=FULL_RUN_VER, **dirs)
    src = make_config("yelp", dump_dir=os.path.join(work, "dump"),
                      out_dir=os.path.join(work, "output"))
    os.makedirs(cfg.ds_dump_dir)
    for path in (*src.vocab_paths, src.w2v_path):
        shutil.copy(path, cfg.ds_dump_dir)
    shutil.copytree(cli._eval_dir(src), cli._eval_dir(cfg),
                    ignore=shutil.ignore_patterns("adv_models"))
    B, L, device = cfg.batch_size, cfg.max_len, torch.device(cfg.device)
    n_train, n_dev = count_lines(cfg.train_files()), count_lines(cfg.split_files("dev"))
    dev_batches = -(-n_dev // B)

    def stage(argv):
        fused_decode_logits.launches = 0
        sinkhorn_cuda.launches = 0
        zero_lstm_launches()
        t0 = time.perf_counter()
        with watch_graphs() as made:
            lines = run_cli(argv)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        log(f"phase 11: {argv[0]} in {s:.1f} s")
        return lines, s, made, fused_decode_logits.launches, sinkhorn_cuda.launches

    def epochs_of(events):
        return [e for e in events if "train_steps" in e]

    def seconds(epochs):
        return {"train_s": [e["train_s"] for e in epochs], "val_s": [e["val_s"] for e in epochs],
                "train_s_after_first": [e["train_s"] for e in epochs[1:]],
                "val_s_after_first": [e["val_s"] for e in epochs[1:]]}

    # 1. pretrain: the preset's epochs, freeze-on-plateau per tower
    _, pre_s, made, head, sink = stage(["pretrain", *flags])
    pre_events = read_events(cfg, "pretrain")
    pre_losses = check_finite_losses(pre_events, ("cls_loss", "dn_loss", "val_loss"), "pretrain")
    pre_epochs = epochs_of(pre_events)
    pre_flags = [tuple(math.isfinite(e[f"val_{t}"]) for t in ("cls", "mat", "dn"))
                 for e in pre_epochs]
    # the matcher's inputs, and so its labels, are made while it trains
    labeled = sum(n_train // B + dev_batches for f in pre_flags if f[1])
    check(sink == labeled, f"pretrain: {sink} Sinkhorn launches, want {labeled}")
    check(head == 0, "pretrain launched the decode head")
    lstm_launches("pretrain_full_run", 0)
    pre_sink, pre_head = sink, head
    check(all(e["train_steps"] == n_train // B for e in pre_epochs), "pretrain: steps an epoch")
    keys = sorted(set(pre_flags), key=str)
    pre_graphs = check_replayed(made, keys, len(pre_epochs) * (n_train // B), "pretrain",
                                steps=2)
    pre_val_graphs = check_replayed(made, keys, len(pre_epochs) * dev_batches,
                                    "pretrain validation", steps=2, index=1)

    # 2. warmup, 10 epochs (patience 1)
    _, warm_s, made, head, sink = stage(["warmup", *flags, "--warmup_epochs",
                                         str(FULL_RUN_WARMUP_EPOCHS)])
    check(head == 0 and sink == 0, "warmup launched a kernel of the port")
    warm_head = head
    warm_events = read_events(cfg, "warmup")
    warm_losses = check_finite_losses(warm_events, ("dn_loss", "val_loss"), "warmup")
    warm_epochs = epochs_of(warm_events)
    warm_steps = n_train // cfg.warmup_batch_size
    check(all(e["train_steps"] == warm_steps for e in warm_epochs), "warmup: steps an epoch")
    warm_graphs = check_replayed(made, [None], len(warm_epochs) * warm_steps, "warmup", steps=2)
    warm_cells = lstm_launches("warmup_full_run", None, 3 * L * len(warm_epochs) * warm_steps)
    warm_val_graphs = check_replayed(made, [None], len(warm_epochs)
                                     * -(-n_dev // cfg.warmup_batch_size),
                                     "warmup validation", steps=2, index=1)

    # 3. run: optimize (10 epochs, patience 3), infer, eval-prepare, eval
    with launches_inside(optimize_stage, ("run_optimize", "run_test")) as inside:
        lines, run_s, made, head, sink = stage(["run", *flags])
    check(sink == 0, "run launched the Sinkhorn")
    infer_batches = sum(-(-count_lines(cfg.split_files(s)) // B) for s in ("train", "test"))
    opt_head, head = inside["run_optimize"]["head"], inside["run_test"]["head"]
    check(opt_head == 0 and head == L * infer_batches,
          f"run: {opt_head} decode-head launches in optimize, want 0; {head} in infer, want "
          f"{L} x {infer_batches}; {inside}")
    opt_events = read_events(cfg, f"optimize-{FULL_RUN_VER}")
    opt_losses = check_finite_losses(opt_events, ("G", "STI", "CP", "BK", "D", "loss",
                                                  "val_loss"), "optimize")
    opt_epochs = epochs_of(opt_events)
    check(all(e["train_steps"] == n_train // B for e in opt_epochs), "optimize: steps an epoch")
    opt_steps = len(opt_epochs) * (n_train // B)
    step_fwd, step_bwd = fused_step_cells(cfg)
    opt_cells = lstm_launches("optimize_full_run", None, step_bwd * opt_steps,
                              counts=(inside["run_optimize"]["lstm_fwd"],
                                      inside["run_optimize"]["lstm_bwd"]))
    check(opt_cells["forward"] > step_fwd * opt_steps,
          f"run: {opt_cells} LSTM cell launches in optimize, want the steps' and validation's")
    infer_cells = lstm_launches("run_full", greedy_cells(head),
                                counts=(inside["run_test"]["lstm_fwd"],
                                        inside["run_test"]["lstm_bwd"]))
    # and none in eval-prepare and eval
    lstm_launches("run_full_all_stages", opt_cells["forward"] + infer_cells["forward"],
                  opt_cells["backward"], keep=False)
    # made: the optimize validation's graphed step, then the infer's
    opt_val_graphs = check_replayed(made, [None], len(opt_epochs) * dev_batches,
                                    "optimize validation", steps=2)
    infer_graphs = check_replayed(made, [(B, L)], infer_batches, "infer", steps=2, index=1)
    timings, adv_printed = prepare_printed(lines)
    check(len(timings) == 1 and set(timings[0]) == {"adv_lr_s"},
          f"run's eval-prepare rebuilt more than this version's LR: {timings}")
    check(len(adv_printed) == 1 and adv_printed[0]["solver"] == "native",
          f"run's adversarial LR: {adv_printed}")
    results_path = os.path.join(cfg.out_dir, f"{cfg.dataset}-{FULL_RUN_VER}.txt")
    check(os.path.exists(results_path), f"missing {results_path}")
    with open(results_path, encoding="utf-8") as f:
        written = f.read()
    for label in ("STI (higher is better)", "CP (lower is better)", "NT (higher is better)"):
        check(label in written, f"{results_path} has no {label} line")
    scores = run_eval(cfg.ds_data_dir, cfg.run_out_dir, cli._eval_dir(cfg), cfg.dataset,
                      cfg.ver, quiet=True)
    # adv_lr_s split (eval-prepare's own line: reading and writing the
    # files, the transform, the C++ fit and its iterations); the saved LR
    # held to the stopping rule on the matrix it was fitted on
    p = eval_paths(cli._eval_dir(cfg), cfg.dataset, cfg.ver)
    adv_lr = {"card": card, "adv_lr_s": timings[0]["adv_lr_s"],
              **saved_adversarial_lr(cfg, p, adv_printed[0], "phase 11")}
    print(json.dumps({"phase 11 adv_lr": adv_lr}), flush=True)
    epochs_run = {"pretrain": len(pre_epochs), "warmup": len(warm_epochs),
                  "optimize": len(opt_epochs)}
    log(f"phase 11: epochs run: {epochs_run} (configured: pretrain {cfg.epochs}, warmup "
        f"{FULL_RUN_WARMUP_EPOCHS}, optimize {cfg.epochs})")

    # the band around the JAX package's default-RNG row; the threefry rows
    # beside it, unchecked
    band = {k: [FULL_RUN_JAX[k] - w, FULL_RUN_JAX[k] + w] for k, w in FULL_RUN_BAND.items()}
    outside = [k for k, (lo, hi) in band.items() if not lo <= scores[k] <= hi]
    for k, (lo, hi) in band.items():
        print(f"phase 11 {k}: {scores[k]} band [{lo}, {hi}] around the JAX package's "
              f"{FULL_RUN_JAX[k]} (RESULTS.md:315) {'OUTSIDE' if k in outside else 'inside'}; "
              + "; ".join(f"{src}: {row.get(k, 'none')}" for src, row in
                          FULL_RUN_THREEFRY.items()), flush=True)

    # the three validation passes on the trained weights, in the run's bf16,
    # timed once each way
    val_passes = {s: validation_passes(cfg, s, device, passes=1)
                  for s in ("pretrain", "warmup", "optimize")}
    for v in val_passes.values():
        for key, b in v["branches"].items():
            check(b["finite"], f"{v['stage']} validation {key}: non-finite losses")
            check(b["loss_max_rel_diff"] <= GRAPH_TOL["bfloat16"]["loss_rel"],
                  f"{v['stage']} validation {key}: bf16 graphed losses "
                  f"{b['loss_max_rel_diff']} apart")

    result = {
        "card": card, "recipe": "RESULTS.md:1103-1110 (the JAX package's 16k yelp smoke): "
        "vocab, w2v, pretrain, warmup --warmup_epochs 10, run (optimize 10 epochs, infer, "
        "eval-prepare, eval); patience 1 / 1 / 3",
        "reference": {"row": "RESULTS.md:315 (16k smoke, rng_impl rbg, the JAX default)",
                      "scores": FULL_RUN_JAX, "band_half_widths": FULL_RUN_BAND, "band": band},
        "threefry_rows_unchecked": FULL_RUN_THREEFRY,
        "dtype": cfg.dtype, "seed": cfg.seed, "V": len(get_tokenizer(cfg)),
        "L": L, "B": B, "train_sentences": n_train, "dev_sentences": n_dev,
        "dumps": "phase 3's BPE and phase 5's word2vec copied (what vocab and w2v write); "
                 "phase 7's classifier, lexicon and masked word2vec copied",
        "scores": scores, "outside_band": outside, "epochs_run": epochs_run,
        "epochs_configured": {"pretrain": cfg.epochs, "warmup": FULL_RUN_WARMUP_EPOCHS,
                              "optimize": cfg.epochs},
        "wall_s": {"pretrain": pre_s, "warmup": warm_s, "run": run_s},
        "pretrain": {**seconds(pre_epochs), "flags": [list(f) for f in pre_flags],
                     "val_loss": [e["val_loss"] for e in pre_epochs], "losses": pre_losses,
                     "sinkhorn_launches": pre_sink, "decode_head_launches": pre_head,
                     "graphs": pre_graphs, "validation_graphs": pre_val_graphs},
        "warmup": {**seconds(warm_epochs), "val_loss": [e["val_loss"] for e in warm_epochs],
                   "losses": warm_losses, "graphs": warm_graphs,
                   "validation_graphs": warm_val_graphs, "decode_head_launches": warm_head,
                   "lstm_cell_launches": warm_cells},
        "optimize": {**seconds(opt_epochs), "val_loss": [e["val_loss"] for e in opt_epochs],
                     "d_applies": [e["d_applies"] for e in opt_epochs], "losses": opt_losses,
                     "validation_graphs": opt_val_graphs, "decode_head_launches": opt_head,
                     "lstm_cell_launches": opt_cells},
        "infer": {"batches": infer_batches, "decode_head_launches": head,
                  "graphs": infer_graphs, "lstm_cell_launches": infer_cells},
        "prepare_timings": timings[0], "adv_lr": adv_lr,
        "results": written.strip().splitlines(),
        "validation_passes_bf16": val_passes,
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"full_run": result}), flush=True)
    check(not outside, f"phase 11: {outside} outside the band: {scores}")
    return result


# ------------------------------------------------------------------ phase 12
def phase_book(work: str, card: str) -> dict:
    """The book dataset (``data/book``: L=30, B=128, warmup B=512, no human
    references) end to end through the port's CLI, on the first
    BOOK_CUT_LINES lines of each split file (a cut of depth; every width is
    book's own: BPE ``vocab_size=10000``, the 6-layer / 8-head / d=512
    scorers, the generator's widths, bf16 autocast over float32 parameters,
    seed 0), in a fresh dump dir:
    1. ``vocab``, ``w2v``, ``pretrain --epochs 1``, ``warmup`` (one epoch)
       and ``run --epochs 1`` (optimize, ``infer``, ``eval-prepare``,
       ``eval``): checkpoints load strictly, every logged loss is finite,
       one step a batch, D applied ceil(steps / d_update_every) times, every
       train step, dev batch and infer batch a graph replay but the first
       of each branch, the Sinkhorn once a labeled pretrain batch, the
       decode head 0 times in training and L times an infer batch, and
       ``eval``'s STI, CP, NT, ACC and self-BLEU finite and in range, with
       no ref-BLEU line; then ``serve`` on BOOK_SERVE_LINES test lines;
    2. the Sinkhorn on a real book label batch (45 atoms a side) against
       its plain version, graph-timed beside the labeler's host time, and
       the collate's host ms a batch (noise and labels, as the prefetcher's
       thread runs it);
    3. the graphed pretrain, warmup and optimize steps at the CLI's
       settings: ms per step, device ms, idle share, peak memory;
    4. float32 replays of the pretrain (two flag tuples), warmup and
       optimize steps against eager steps from one state (dropout on), and
       the three stages' validation passes graphed against eager, with
       equal losses;
    5. greedy serving at B=128 on the trained G (bf16, graphed; ms per
       batch, sentences/s, device ms, idle share), the card's float32 greedy
       ids against the CPU's on BOOK_CHECK_N test sentences, and the float32
       beam of 4 on one book batch, graphed against eager;
    6. the decode head at B=128 and book's V in bf16 and float32 against
       its plain version, graph-timed beside the plain version and the
       library call, with its bound."""
    import numpy as np
    import torch

    from consistent__style_transfer_torch import cli
    from consistent__style_transfer_torch.config import make_config
    from consistent__style_transfer_torch.data.pipeline import make_batches
    from consistent__style_transfer_torch.data.prefetch import DevicePrefetcher
    from consistent__style_transfer_torch.data.wmd_labels import SinkhornWmdLabeler
    from consistent__style_transfer_torch.evaluate.prepare import eval_paths
    from consistent__style_transfer_torch.evaluate.run_eval import run_eval
    from consistent__style_transfer_torch.kernels.decode_step import fused_decode_logits
    from consistent__style_transfer_torch.kernels.sinkhorn import sinkhorn_cuda
    from consistent__style_transfer_torch.models import PairMatcher, TextCNN, TransformerLM
    from consistent__style_transfer_torch.models.generator import DenoiseSeq2Seq
    from consistent__style_transfer_torch.text.fasttext_cls import GRAPH_CHUNK, FastTextClassifier
    from consistent__style_transfer_torch.train import optimize as optimize_stage
    from consistent__style_transfer_torch.train.common import (build_classifier,
                                                               build_generator, build_lm,
                                                               build_matcher, get_corpus,
                                                               get_tokenizer, get_w2v)
    from consistent__style_transfer_torch.train.graphs import GraphedStep
    from consistent__style_transfer_torch.train.infer import make_transfer_step
    from consistent__style_transfer_torch.train.optimize import load_generator_params
    from consistent__style_transfer_torch.train.pretrain import (TASKS, make_pretrain_steps,
                                                                 step_inputs)
    from consistent__style_transfer_torch.train.state import AdamWithClip, newest_checkpoint
    from consistent__style_transfer_torch.train.warmup import WARMUP_INPUTS, make_warmup_steps

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # as a fresh process has it
    base = os.path.join(work, "book")
    dirs = dict(data_dir=os.path.join(base, "data"), dump_dir=os.path.join(base, "dump"),
                out_dir=os.path.join(base, "output"), log_dir=os.path.join(base, "log"))
    flags = ["--dataset", "book"] + [a for k, v in dirs.items() for a in (f"--{k}", v)]
    cfg = make_config("book", **dirs)
    cut_corpus(make_config("book", data_dir=os.path.join(ROOT, "data")), cfg, BOOK_CUT_LINES)
    B, L, WB, device = cfg.batch_size, cfg.max_len, cfg.warmup_batch_size, torch.device("cuda")
    check((L, B, WB) == (30, 128, 512), f"book's preset: L={L}, B={B}, warmup B={WB}")
    check(not any(os.path.exists(os.path.join(cfg.ds_data_dir, f"reference.{k}"))
                  for k in (0, 1)), "the book corpus has human references")
    n_train, n_dev = count_lines(cfg.train_files()), count_lines(cfg.split_files("dev"))
    n_test = count_lines(cfg.split_files("test"))
    dev_batches = -(-n_dev // B)
    cli_s = {}

    def stage(argv, stdin_text=""):
        fused_decode_logits.launches = 0
        sinkhorn_cuda.launches = 0
        zero_lstm_launches()
        t0 = time.perf_counter()
        with watch_graphs() as made, watch_graphs(optimize_stage, "GraphedFusedStep") as fused:
            lines = run_cli(argv, stdin_text)
        torch.cuda.synchronize()
        cli_s[argv[0]] = time.perf_counter() - t0
        log(f"phase 12: {argv[0]} in {cli_s[argv[0]]:.1f} s")
        return lines, made, fused, fused_decode_logits.launches, sinkhorn_cuda.launches

    def no_kernel(what, head, sink):
        check(head == 0 and sink == 0, f"book {what} launched a kernel: head {head}, "
              f"Sinkhorn {sink}")

    def epoch_of(stage_name, steps):
        events = read_events(cfg, stage_name)
        epochs = [e for e in events if "train_steps" in e]
        check(len(epochs) == 1 and epochs[0]["train_steps"] == steps,
              f"book {stage_name}: epochs {epochs}, want one of {steps} steps")
        check(epochs[0]["val_s"] > 0, f"book {stage_name} logged val_s {epochs[0]['val_s']}")
        return events, epochs[0]

    # 1. the CLI chain
    _, _, _, head, sink = stage(["vocab", *flags])
    no_kernel("vocab", head, sink)
    lstm_launches("vocab_book", 0)
    tokenizer = get_tokenizer(cfg)
    V = len(tokenizer)
    log(f"phase 12: book BPE at vocab_size {cfg.vocab_size}: V={V}")
    _, _, _, head, sink = stage(["w2v", *flags])
    no_kernel("w2v", head, sink)
    lstm_launches("w2v_book", 0)
    check(os.path.exists(cfg.w2v_path), f"w2v wrote no {cfg.w2v_path}")

    _, made, _, pre_head, pre_sink = stage(["pretrain", *flags, "--epochs", "1"])
    labeled = n_train // B + dev_batches  # train drops its last partial batch
    check(pre_sink == labeled, f"book pretrain: {pre_sink} Sinkhorn launches, want one per "
          f"labeled batch = {labeled}")
    check(pre_head == 0, "book pretrain launched the decode head")
    lstm_launches("pretrain_book", 0)
    for task, cls in (("cls", TextCNN), ("mat", PairMatcher), ("dn", TransformerLM)):
        path = os.path.join(cfg.ds_dump_dir, "pretrain", f"{task}.pth")
        check(os.path.exists(path), f"missing {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        cls(V).load_state_dict(sd, strict=True)
        check(all(bool(torch.isfinite(v).all()) for v in sd.values()), f"{path}: non-finite")
    events, pre_epoch = epoch_of("pretrain", n_train // B)
    pre_losses = check_finite_losses(events, ("cls_loss", "mat_loss", "dn_loss", "val_loss"),
                                     "book pretrain")
    full, frozen = (True, True, True), (True, False, True)
    pre_graphs = check_replayed(made, [full], n_train // B, "book pretrain", steps=2)
    pre_val_graphs = check_replayed(made, [full], dev_batches, "book pretrain validation",
                                    steps=2, index=1)

    def load_g(path):
        check(os.path.exists(path), f"missing {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        DenoiseSeq2Seq(V, cfg.n_class, L).load_state_dict(sd, strict=True)
        check(all(bool(torch.isfinite(v).all()) for v in sd.values()), f"{path}: non-finite")

    _, made, _, warm_head, sink = stage(["warmup", *flags])
    no_kernel("warmup", warm_head, sink)
    warm_cells = lstm_launches("warmup_book", None, 3 * L * (n_train // WB))
    warm_path = os.path.join(cfg.ds_dump_dir, "warmup", "G.pth")
    load_g(warm_path)
    events, warm_epoch = epoch_of("warmup", n_train // WB)
    warm_losses = check_finite_losses(events, ("dn_loss", "val_loss"), "book warmup")
    warm_graphs = check_replayed(made, [None], n_train // WB, "book warmup", steps=2)
    warm_val_graphs = check_replayed(made, [None], -(-n_dev // WB), "book warmup validation",
                                     steps=2, index=1)

    with launches_inside(optimize_stage, ("run_optimize", "run_test")) as inside:
        lines, made, fused, _, sink = stage(["run", *flags, "--epochs", "1"])
    check(sink == 0, "book run launched the Sinkhorn")
    infer_batches = -(-n_train // B) + -(-n_test // B)
    opt_head, run_head = inside["run_optimize"]["head"], inside["run_test"]["head"]
    check(opt_head == 0 and run_head == L * infer_batches,
          f"book run: {opt_head} decode-head launches in optimize, want 0; {run_head} in "
          f"infer, want {L} x {infer_batches}; {inside}")
    task = os.path.join(cfg.ds_dump_dir, f"optimize-{cfg.ver}")
    best = newest_checkpoint(task)
    check(best == os.path.join(task, "G_epoch_0.pth"), f"book optimize kept {best}")
    load_g(best)
    events, opt_epoch = epoch_of(f"optimize-{cfg.ver}", n_train // B)
    opt_losses = check_finite_losses(events, ("G", "STI", "CP", "BK", "D", "loss", "val_loss"),
                                     "book optimize")
    want = math.ceil(opt_epoch["train_steps"] / cfg.d_update_every)
    check(opt_epoch["d_applies"] == want, f"book optimize: D applied {opt_epoch['d_applies']}, "
          f"want {want}")
    opt_graphs = check_replayed(fused, [True, False], n_train // B, "book optimize")
    step_fwd, step_bwd = fused_step_cells(cfg)
    opt_cells = lstm_launches("optimize_book", None, step_bwd * opt_epoch["train_steps"],
                              counts=(inside["run_optimize"]["lstm_fwd"],
                                      inside["run_optimize"]["lstm_bwd"]))
    check(opt_cells["forward"] > step_fwd * opt_epoch["train_steps"],
          f"book run: {opt_cells} LSTM cell launches in optimize, want the steps' and "
          "validation's")
    opt_graphs["lstm_cell_launches_per_replay"] = {
        str(k): lstm_launches(f"optimize_book_run_graph_{k}", step_fwd, step_bwd,
                              counts=replayed_cells(fused[0], k)) for k in (True, False)}
    run_cells = lstm_launches("run_book", greedy_cells(run_head),
                              counts=(inside["run_test"]["lstm_fwd"],
                                      inside["run_test"]["lstm_bwd"]))
    # made: the optimize validation's graphed step, the infer's, then the
    # eval classifier fit's (its epochs in chunks of GRAPH_CHUNK steps)
    opt_val_graphs = check_replayed(made, [None], dev_batches, "book optimize validation",
                                    steps=3)
    infer_graphs = check_replayed(made, [(B, L)], infer_batches, "book infer", steps=3, index=1)
    fit_steps = -(-n_train // 64)
    fit_graphs = check_replayed(
        made, [(64, k) for k in sorted({GRAPH_CHUNK, fit_steps % GRAPH_CHUNK} - {0})],
        5 * -(-fit_steps // GRAPH_CHUNK), "book classifier fit", steps=3, index=2)
    for split in ("train", "test"):
        for k, src in enumerate(cfg.split_files(split)):
            path = os.path.join(cfg.run_out_dir, f"style.{split}.{k}.tsf")
            with open(path, encoding="utf-8") as f:
                got = len(f.read().splitlines())
            check(got == count_lines([src]), f"{path}: {got} lines, want {count_lines([src])}")
    timings, adv_printed = prepare_printed(lines)
    check(len(timings) == 1 and set(timings[0]) == {"classifier_s", "lexicon_s", "mask_s",
                                                     "mask_w2v_s", "adv_lr_s"},
          f"book eval-prepare timings: {timings}")
    check(len(adv_printed) == 1 and adv_printed[0]["solver"] == "native",
          f"book adversarial LR: {adv_printed}")
    prepare_beside = {"card": card, "adversarial_lr": saved_adversarial_lr(
        cfg, eval_paths(cli._eval_dir(cfg), cfg.dataset, cfg.ver), adv_printed[0], "book"), **{
        k: {"this_run": timings[0][k], "before_compiled_solver_and_graphed_fit": v}
        for k, v in BOOK_PREPARE_BEFORE_S.items()}}
    print(json.dumps({"phase 12 eval-prepare": prepare_beside}), flush=True)
    fit_meta = FastTextClassifier.load_model(
        eval_paths(cli._eval_dir(cfg), cfg.dataset, cfg.ver)["classifier"]).fit_meta
    check(fit_meta.get("sgd_path") == "minibatch" and fit_meta.get("retries") == 0,
          f"book classifier fit_meta {fit_meta}")
    scores = run_eval(cfg.ds_data_dir, cfg.run_out_dir, cli._eval_dir(cfg), cfg.dataset,
                      cfg.ver, quiet=True)
    printed = "\n".join(lines)
    for key, label, fmt in (("STI", "STI (higher is better)", "%.4f"),
                            ("CP", "CP (lower is better)", "%.4f"),
                            ("NT", "NT (higher is better)", "%.4f"),
                            ("ACC", "ACC (transfer accuracy)", "%.4f"),
                            ("selfBLEU", "self-BLEU", "%.2f")):
        check(key in scores and f"{label}: {fmt % scores[key]}" in printed,
              f"book eval printed no {label} line equal to {scores.get(key)}")
    samples = []
    for k in (0, 1):
        with open(cfg.split_files("test")[k], encoding="utf-8") as a, \
                open(os.path.join(cfg.run_out_dir, f"style.test.{k}.tsf"), encoding="utf-8") as b:
            samples += [[src.strip(), out.strip()] for src, out, _ in zip(a, b, range(2))]
    check("refBLEU" not in scores and "ref-BLEU" not in printed,
          "book eval printed a ref-BLEU line without references")
    check(-1 <= scores["STI"] <= 1 and math.isfinite(scores["CP"]) and scores["CP"] >= 0
          and 0 <= scores["NT"] <= 1 and 0 <= scores["ACC"] <= 1
          and math.isfinite(scores["selfBLEU"]) and 0 <= scores["selfBLEU"] <= 100,
          f"book scores out of range: {scores}")
    results_path = os.path.join(cfg.out_dir, f"{cfg.dataset}-{cfg.ver}.txt")
    with open(results_path, encoding="utf-8") as f:
        written = f.read()
    check("STI (higher is better)" in written and "ref-BLEU" not in written,
          f"{results_path}: {written}")

    requests = []
    for label in (0, 1):
        with open(os.path.join(cfg.ds_data_dir, f"style.test.{label}"), encoding="utf-8") as f:
            requests += [f"{label}\t{line.strip()}" for line in f if line.strip()]
    requests = requests[:: max(1, len(requests) // BOOK_SERVE_LINES)][:BOOK_SERVE_LINES]
    served, made, _, serve_head, sink = stage(["serve", *flags], "\n".join(requests) + "\n")
    serve_batches = -(-len(requests) // B)
    check(sink == 0 and serve_head == L * serve_batches,
          f"book serve: {serve_head} decode-head launches, want {L} x {serve_batches}")
    check(len(served) == len(requests), f"book serve printed {len(served)} of {len(requests)}")
    serve_cells = lstm_launches("serve_book", greedy_cells(serve_head))
    serve_graphs = check_replayed(made, [(B, L)], serve_batches, "book serve")

    lap = laps("phase 12")
    # 2. the Sinkhorn on a real book label batch, and the collate's pace
    labeler = SinkhornWmdLabeler(get_w2v(cfg, tokenizer), tokenizer, max_atoms=L + L // 2,
                                 device=device)
    check(labeler.max_atoms == 45, f"book labeler capacity {labeler.max_atoms}")
    corpus = get_corpus(cfg, "train", tokenizer)
    real = real_label_batch(cfg, labeler, corpus)
    check(max(real["atoms"]) == 45, f"book label batch atoms {real['atoms']}")
    print(json.dumps({"book_sinkhorn_label_batch": real}), flush=True)
    collate = iter(make_batches(corpus, B, L, "pretrain", shuffle=True, seed=1,
                                wmd_labeler=labeler))
    next(collate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        next(collate)
    collate_ms = (time.perf_counter() - t0) * 1e3 / 20  # the host's; the labels stay queued
    torch.cuda.synchronize()
    del collate

    lap("the real label batch and the collate")
    # 3. the graphed steps at the CLI's settings
    towers = {"cls": build_classifier(cfg, V, device), "mat": build_matcher(cfg, V, device),
              "dn": build_lm(cfg, V, device)}
    pre_step, _ = make_pretrain_steps(
        towers, AdamWithClip([p for t in TASKS for p in towers[t].parameters()],
                             cfg.pretrain_lr, cfg.pretrain_clip), autocast_dtype=torch.bfloat16)
    gen = torch.Generator(device).manual_seed(0)
    runner = GraphedStep(lambda inputs, f: pre_step(inputs, f, gen), (gen,))
    stream = iter(DevicePrefetcher(make_batches(corpus, B, L, "pretrain", shuffle=True, seed=1,
                                                wmd_labeler=labeler), device))

    def graphed_pre():
        arrays = next(stream)[1]
        return runner({k: arrays[k] for k in step_inputs(full)}, full)

    try:
        pre_steady = steady_step(graphed_pre, batches=10)
        check(all(bool(torch.isfinite(v)) for v in graphed_pre().values()),
              "non-finite graphed book pretrain losses")
    finally:
        stream.close()
    pre_steady["graph_nodes"] = graph_nodes(runner.graphs[full])
    del towers, pre_step, runner
    fused_decode_logits.launches = 0
    sinkhorn_cuda.launches = 0

    def stream_of(stage_name, batch_size, seed=1):
        return iter(DevicePrefetcher(make_batches(corpus, batch_size, L, stage_name, shuffle=True,
                                                  seed=seed), device))

    model = build_generator(cfg, V, device, training=True)
    model.load_state_dict(torch.load(warm_path, map_location=device, weights_only=True))
    warm_step, _ = make_warmup_steps(model, AdamWithClip(model.parameters(), cfg.warmup_lr,
                                                         cfg.warmup_clip), torch.bfloat16)
    runner = GraphedStep(lambda inputs, _: warm_step(inputs, gen), (gen,))
    batches = stream_of("warmup", WB)

    def graphed_warm():
        arrays = next(batches)[1]
        return runner({k: arrays[k] for k in WARMUP_INPUTS})

    try:
        warm_steady = steady_step(graphed_warm, batches=10)
        check(math.isfinite(graphed_warm().item()), "non-finite graphed book warmup loss")
    finally:
        batches.close()
    warm_steady["graph_nodes"] = graph_nodes(runner.graphs[None])
    del model, warm_step, runner

    # on the run's G_epoch_0
    models, steps, _, acc, gens = build_optimize(cfg, V, device)
    opt_steady = optimize_steady(steps, acc, gens, cfg.d_update_every, stream_of("optimize", B),
                                 batches=12, cells=fused_step_cells(cfg), what="optimize_book")
    del models, steps, acc
    check(fused_decode_logits.launches == 0 and sinkhorn_cuda.launches == 0,
          "a graphed book warmup or optimize step launched a kernel of the port")

    lap("the graphed steps' steady times")
    # 4. float32 replays against eager steps, and validation passes
    f32 = make_config("book", dtype="float32", **dirs)
    pre_replay = pretrain_replays(f32, V, corpus, labeler, work, what="book_pretrain")
    warm_replay = warmup_replays(f32, V, device, warm_path, corpus)
    print(json.dumps({"book_warmup_replay_vs_eager": warm_replay}), flush=True)
    check_replays(warm_replay, "book warmup")
    batches = stream_of("optimize", B, seed=3)
    try:
        fixed = [next(batches)[1] for _ in range(TF_REPLAY_STEPS + 2)]
    finally:
        batches.close()
    opt_replay = optimize_replays(f32, V, device, fixed, "book")
    del fixed
    torch.backends.cudnn.allow_tf32 = True
    lap("the float32 step replays")
    val_replay = {s: validation_passes(f32, s, device, passes=1)
                  for s in ("pretrain", "warmup", "optimize")}
    print(json.dumps({"book_validation_replay_vs_eager": val_replay}), flush=True)
    for v in val_replay.values():
        check_validation_equal(v)

    lap("the validation passes")
    # 5. serving at B=128 on the trained G; float32 ids against the CPU's;
    # the float32 beam of 4, graphed against eager
    test = get_corpus(cfg, "test", tokenizer)
    rows = np.linspace(0, len(test) - 1, B).astype(int)  # both styles
    x = torch.from_numpy(test.ids[rows]).to(device)
    labels = torch.from_numpy(test.labels[rows]).to(device)
    check(tuple(x.shape) == (B, L), f"book test batch {tuple(x.shape)}")
    serving = build_generator(cfg, V, device)  # bf16 serving weights, as serve loads them
    load_generator_params(cfg, serving)
    step = make_transfer_step(serving)
    for _ in range(3):
        step(x, labels)
    torch.cuda.synchronize()
    fused_decode_logits.launches = 0
    zero_lstm_launches()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        step(x, labels)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3 / n
    check(fused_decode_logits.launches == L * n, f"book serving: "
          f"{fused_decode_logits.launches} head launches, want {L} x {n}")
    serving_cells = lstm_launches("serving_book", greedy_cells(L * n))
    prof = profile_breakdown(lambda: step(x, labels), watch=("ffn_", "vocab_argmax"))
    device_ms = prof.get("device_ms_per_batch")
    serving_row = {"dtype": cfg.dtype, "B": B, "L": L, "V": V, "ms_per_batch": serve_ms,
                   "sent_per_s": B * 1e3 / serve_ms, "device_ms_per_batch": device_ms,
                   "device_idle_share": (1 - device_ms / serve_ms)
                   if isinstance(device_ms, float) else "not measured",
                   "head_launches_per_batch": L, "watched": prof.get("watched", "not measured"),
                   "lstm_cell_launches_per_batch": serving_cells["forward"] / n,
                   "graph_nodes": graph_nodes(step.runner.graphs[(B, L)]),
                   **peak_memory(lambda: step(x, labels))}
    del serving, step
    cfg32 = make_config("book", dtype="float32", mode="test", **dirs)
    rows = np.linspace(0, len(test) - 1, BOOK_CHECK_N).astype(int)
    xs, ls = test.ids[rows], test.labels[rows]
    ids = {}
    for dev in ("cuda", "cpu"):
        model = build_generator(cfg32, V, torch.device(dev))
        load_generator_params(cfg32, model)
        transfer = make_transfer_step(model)
        for _ in range(2):  # on the card: the eager first call, then a replay
            ids[dev] = transfer(torch.from_numpy(xs).to(dev), torch.from_numpy(ls).to(dev)).cpu()
        if dev == "cuda":
            beam = beam_graphed_vs_eager(model, x, labels, BEAM_K)
        del model, transfer
    agree = (ids["cuda"] == ids["cpu"]).float().mean().item()
    check(agree == 1.0, f"book f32 greedy ids on the card agree with the CPU on {agree:.3f}")

    lap("serving, the card against the CPU and the beam")
    # 6. the decode head at B=128 and book's V
    head_checks, head_timed = [], {}
    for seed, (dtype_name, dtype) in enumerate((("bfloat16", torch.bfloat16),
                                                ("float32", torch.float32))):
        hx, w1, b1, w2 = head_inputs(B, V, dtype, 40 + seed)
        row = check_head(hx, w1, b1, w2, dtype_name)
        head_checks.append(row)
        head_timed[dtype_name] = {**head_times(hx, w1, b1, w2, dtype_name, 40 + seed),
                                  "max_abs_err_h": row["max_abs_err_h"],
                                  "ids_mismatch": row["ids_mismatch"]}
        check(head_timed[dtype_name]["kernel_device_ops_per_call"] == 2,
              f"book decode head {dtype_name}: device operations per call")
    print(json.dumps({"book_decode_head": {"checks": head_checks, "times": head_timed}}),
          flush=True)
    lap("the decode head")

    idle = pre_steady["device_idle_share"]
    result = {
        "card": card, "corpus": f"data/book, the first {BOOK_CUT_LINES} lines a style",
        "dtype": "bfloat16 autocast, float32 parameters", "seed": cfg.seed, "V": V, "L": L,
        "B": B, "warmup_B": WB, "scorer": "6 layers / 8 heads / d=512", "vocab_size": cfg.vocab_size,
        "train_sentences": n_train, "dev_sentences": n_dev, "test_sentences": n_test,
        "cli_s": cli_s, "prepare_timings": timings[0], "prepare_beside": prepare_beside,
        "classifier_fit": fit_meta, "classifier_fit_graphs": fit_graphs,
        "scores": scores, "test_transfers": samples,
        "results": written.strip().splitlines(),
        "pretrain": {"sinkhorn_launches": pre_sink, "labeled_batches": labeled,
                     "decode_head_launches": pre_head,
                     "train_steps": pre_epoch["train_steps"], "train_s": pre_epoch["train_s"],
                     "val_s": pre_epoch["val_s"],
                     "ms_per_step_epoch": pre_epoch["train_s"] * 1e3 / pre_epoch["train_steps"],
                     "graphs": pre_graphs, "validation_graphs": pre_val_graphs,
                     "losses": pre_losses, "graphed": pre_steady,
                     "collate_host_ms_per_batch": collate_ms,
                     "collate_sets_the_pace": (isinstance(idle, float)
                                               and collate_ms > pre_steady["device_ms_per_step"]),
                     "replay_vs_eager": pre_replay},
        "warmup": {"train_steps": warm_epoch["train_steps"], "train_s": warm_epoch["train_s"],
                   "val_s": warm_epoch["val_s"], "graphs": warm_graphs,
                   "decode_head_launches": warm_head, "lstm_cell_launches": warm_cells,
                   "validation_graphs": warm_val_graphs, "losses": warm_losses,
                   "graphed": warm_steady, "replay_vs_eager": warm_replay},
        "optimize": {"train_steps": opt_epoch["train_steps"], "train_s": opt_epoch["train_s"],
                     "val_s": opt_epoch["val_s"], "d_applies": opt_epoch["d_applies"],
                     "graphs": opt_graphs, "validation_graphs": opt_val_graphs,
                     "losses": opt_losses, "graphed": opt_steady,
                     "replay_vs_eager": opt_replay, "decode_head_launches": opt_head,
                     "lstm_cell_launches": opt_cells},
        "infer": {"batches": infer_batches, "decode_head_launches": run_head,
                  "graphs": infer_graphs, "lstm_cell_launches": run_cells},
        "serve": {"requests": len(requests), "batches": serve_batches,
                  "decode_head_launches": serve_head, "graphs": serve_graphs,
                  "lstm_cell_launches": serve_cells},
        "serving": serving_row,
        "sinkhorn_label_batch": real,
        "validation_replay_vs_eager": val_replay,
        "f32_card_vs_cpu": {"sentences": BOOK_CHECK_N, "agree": agree},
        "beam_graphed_vs_eager": beam,
        "decode_head": head_timed,
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"book": result}), flush=True)
    return result


def lstm_cell_row(cells: dict, build: dict) -> dict:
    """The kernels line's row for the fused LSTM cell: phase 2's times at
    yelp's encoder shape (B=256, H=256, bf16 gates, f32 cell state: 108 of
    a yelp optimize step's 162 cells) with the other shapes and pairs
    beside them, and the launches every path made (LSTM_LAUNCHES)."""
    main = cells["yelp_encoder/bf16_f32"]
    paths = {k: v for k, v in LSTM_LAUNCHES.items() if "_graph_" not in k}
    keep = ("B", "H", "gates", "cell_state", "ms", "fwd_ms", "bwd_ms", "fwd_bwd_autograd_ms",
            "plain_fwd_ms", "plain_ms", "bound_ms", "bound_fwd_ms", "bound_bwd_ms",
            "bound_share", "dgates_rel_f64", "dc_rel_f64", "eager_dgates_rel_f64",
            "eager_dc_rel_f64", "library_fwd_ms", "library_bwd_ms", "library_h_max_abs_diff",
            "library_error")
    return {
        "name": "lstm_cell",
        "route": "cuda",
        "source": "consistent__style_transfer_torch/csrc/lstm_cell.cu",
        "replaces": None,  # the JAX package leaves the cell to XLA
        "launches": sum(v["forward"] + v["backward"] for v in paths.values()),
        "launches_by_path": paths,
        "launches_per_graph_replay": {k: v for k, v in LSTM_LAUNCHES.items() if "_graph_" in k},
        "launch_counter": "lstm_cell_fwd.launches + lstm_cell_bwd.launches: eager calls, and "
                          "each replay adds the calls its graph captured",
        "max_abs_err": 0.0,  # the forward bit for bit, every shape and pair (phase 2)
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bound_share": main["bound_share"],
        "library_ms": (main["library_fwd_ms"] + main["library_bwd_ms"]
                       if "library_fwd_ms" in main else None),
        "library": main["library"],
        "device_ops_per_call": main["device_ops_per_call"],  # graph nodes, exact
        "ptxas": build["ptxas"],
        "shape": {"B": main["B"], "H": main["H"], "gates": main["gates"],
                  "cell_state": main["cell_state"]},
        "shapes": {k: {f: v[f] for f in keep if f in v} for k, v in cells.items()},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    import consistent__style_transfer_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    phase_s = {}

    def phase(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[n] = time.perf_counter() - t0
        log(f"phase {n} passed in {phase_s[n]:.1f} s")
        return out

    card, build = phase("1", phase_card_and_build)
    timed = phase("2, decode head", phase_kernel_vs_plain)
    sinkhorn = phase("2, Sinkhorn", phase_sinkhorn_vs_plain)
    cells = phase("2, LSTM cell", phase_lstm_cell_vs_plain)
    with tempfile.TemporaryDirectory() as work:
        served = phase("3", phase_serve_and_infer, work)
        full = phase("4", phase_full_width, card, timed[f"bfloat16_V{YELP_V}"]["kernel_ms"])
        pre = phase("5", phase_pretrain, work, card)
        trained = phase("6", phase_training, work, card)
        phase("7", phase_eval, work, card)
        mega = phase("8", phase_megastep, work, card, trained["optimize"])
        beams = phase("9", phase_beam_and_transformer, work, card, full)
        launch = phase("10", phase_launcher, work, card)["launcher"]
        full_run = phase("11", phase_full_run, work, card)
        book = phase("12", phase_book, work, card)
    print(json.dumps({"phase_s": phase_s}), flush=True)

    yelp = timed[f"bfloat16_V{YELP_V}"]
    real = pre["sinkhorn_label_batch"]
    book_real = book["sinkhorn_label_batch"]
    sinkhorn_rows = [{
        "name": name,
        "route": "cuda",
        "source": "consistent__style_transfer_torch/csrc/sinkhorn.cu",
        "replaces": f"consistent__style_transfer_tpu/kernels/sinkhorn.py:{line}",
        # one CUDA kernel behind both names: its launches, through either
        "launches": (pre["sinkhorn_launches"] + launch["pretrain"]["sinkhorn_launches"]
                     + full_run["pretrain"]["sinkhorn_launches"]
                     + book["pretrain"]["sinkhorn_launches"]),
        "launches_by_path": {"pretrain": pre["sinkhorn_launches"],
                             "pretrain_launcher": launch["pretrain"]["sinkhorn_launches"],
                             "pretrain_full_run": full_run["pretrain"]["sinkhorn_launches"],
                             "pretrain_book": book["pretrain"]["sinkhorn_launches"]},
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
        # the same, graph-timed on a real book label batch (phase 12)
        "book": {f: book_real[f] for f in (f"{key}_ms", f"{key}_eager_ms", "plain_ms",
                                           "bound_ms", "bound_by", "bound_term",
                                           "valid_terms_per_iter", "valid_atoms", "atoms",
                                           "max_abs_err")},
    } for name, line, key in (("sinkhorn_pallas", 178, "kernel"),
                              ("sinkhorn_pallas_cr", 129, "kernel_cr"))]
    print(json.dumps({"kernels": [{
        "name": "fused_decode_logits",
        "route": "cuda",
        "source": "consistent__style_transfer_torch/csrc/decode_step.cu",
        "replaces": "consistent__style_transfer_tpu/kernels/decode_step.py:73",
        "launches": (served["serve_launches"] + served["infer_launches"]
                     + trained["infer"]["decode_head_launches"]
                     + mega["infer"]["decode_head_launches"]
                     + beams["greedy_beside_beam_launches"]
                     + launch["infer"]["decode_head_launches"]
                     + full_run["infer"]["decode_head_launches"]
                     + book["infer"]["decode_head_launches"]
                     + book["serve"]["decode_head_launches"]),
        "launches_by_path": {"serve": served["serve_launches"], "infer": served["infer_launches"],
                             "warmup": 0, "optimize": 0,
                             "infer_after_optimize": trained["infer"]["decode_head_launches"],
                             "eval_prepare": 0, "eval": 0,
                             "optimize_megastep": 0,
                             "infer_after_megastep": mega["infer"]["decode_head_launches"],
                             "serving_greedy_beside_beam": beams["greedy_beside_beam_launches"],
                             "serving_beam": 0, "serve_beam": 0, "infer_beam": 0,
                             "warmup_transformer": 0, "optimize_transformer": 0,
                             "infer_transformer": 0, "infer_transformer_beam": 0,
                             **{f"{c}_launcher": launch[c]["decode_head_launches"]
                                for c in ("pretrain", "warmup", "optimize", "infer")},
                             **{f"{s}_full_run": full_run[s]["decode_head_launches"]
                                for s in ("pretrain", "warmup", "optimize")},
                             "validation": 0,
                             "run_full": full_run["infer"]["decode_head_launches"],
                             **{f"{s}_book": book[s]["decode_head_launches"]
                                for s in ("pretrain", "warmup", "optimize")},
                             "run_book": book["infer"]["decode_head_launches"],
                             "serve_book": book["serve"]["decode_head_launches"]},
        "launches_per_batch": full["launches_per_batch"],
        "launch_counter": "fused_decode_logits.launches: eager calls, and each replay adds the "
                          "calls its graph captured",
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
        "device_ops_per_call": yelp["kernel_device_ops_per_call"],  # graph nodes, exact
        "profiler_kernels_per_call": yelp["kernel_profiler_kernels_per_call"],
        "library_device_ops_per_call": yelp["library_device_ops_per_call"],
        # profiled inside serving's graph replay (phase 4), a call
        "in_serving_graph_ms": full["head_in_graph_ms_per_call"],
        "sass_hgmma": build["decode_step"]["sass_hgmma"],
        "shape": {"B": YELP_B, "Din": DIN, "H": HID, "V": YELP_V, "dtype": "bfloat16"},
        "other_shapes": {k: v for k, v in timed.items() if k != f"bfloat16_V{YELP_V}"},
        # B=128 at book's V (phase 12), each dtype
        "book": {k: {f: v[f] for f in ("B", "V", "kernel_ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "bound_share", "kernel_warm_ms",
                                       "max_abs_err_h", "ids_mismatch")}
                 for k, v in book["decode_head"].items()},
        "book_launches_per_batch": book["L"],
    }, lstm_cell_row(cells, build["lstm_cell"]), *sinkhorn_rows]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
