#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload yelp.optimize --seed 7 --seconds 30 --trace 0

Sets the cell up from ``--seed`` (weights, traffic), warms every shape it
uses, measures for ``--seconds``, checks what the timed path produced
against the plain reference and prints one JSON line: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
read from a device trace of part of the window. Needs a CUDA card: without
one, or with fewer cards than the cell asks for, it exits 3 and prints no
result. It exits 4, with no result, if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# fixed cache directories inside the checkout, so only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import harness  # noqa: E402
from portbench.lib.manifest import Manifest, load_json  # noqa: E402

T_PROCESS = harness.process_start()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control's and the planted faults' readings beside the program's,
    # for setting the checks' limits; the benchmark's own runs never ask
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, device, root: str = ROOT, overrides: dict | None = None,
            t_process: float | None = None) -> dict:
    """Run the cell on ``device`` and return its result line. ``overrides``
    replaces keys of the configuration (the harness's own tests, on the
    CPU at a tiny size)."""
    import torch

    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    config = {**manifest.config(cell), **(overrides or {})}
    limits = load_json(os.path.join(root, "portbench", "limits", f"{cell['name']}.json"))
    tmp = tempfile.mkdtemp(prefix="portbench-")
    ctx = harness.Context(root=root, cell=cell, config=config, traffic=manifest.traffic(cell),
                          limits=limits, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device(device),
                          cache_dir=os.path.join(root, "portbench", ".cache"), tmp_dir=tmp,
                          t_process=T_PROCESS if t_process is None else t_process,
                          control=bool(args.control))
    try:
        outcome = manifest.driver(cell).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": outcome.memory_peak_bytes}
    metrics, breakdown = {}, None
    if args.trace:
        r = {**outcome.readings, "trace": outcome.trace, "spans": ctx.spans, "config": config,
             "traffic": ctx.traffic}
        for m in manifest.per_layer_of(cell["name"]):
            value = manifest.reader(m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if outcome.trace is not None:
            dev["busy_s"] = outcome.trace.busy_s
            dev["window_s"] = outcome.trace.window_s
            breakdown = {"device_ops": outcome.trace.top_ops(),
                         "idle_gaps": outcome.trace.idle_gaps(ctx.spans)}
    else:
        values = {**outcome.end_to_end, "setup_s": ctx.setup_s}
        for m in manifest.end_to_end_of(cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return harness.line(outcome, metrics, dev, breakdown, ctx.control_readings or None)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    chips = Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    try:
        result = execute(args, "cuda")
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port may load neither JAX nor the "
              "JAX package", file=sys.stderr)
        return 4
    harness.print_checks([(k, v["value"], v["limit"]) for k, v in result["checks"].items()])
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
