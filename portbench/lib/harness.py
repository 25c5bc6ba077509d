"""What every driver shares: the run's context, the seeded weights, the
port's configuration and tokenizer, the import guard and the result line."""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

FORBIDDEN = ("jax", "jaxlib", "flax", "consistent__style_transfer_tpu")


def process_start() -> float:
    """The time this process started, on the ``perf_counter`` clock (from
    /proc; the harness's own start where /proc is missing)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - since
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins like the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    root: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    cache_dir: str
    tmp_dir: str
    t_process: float
    control: bool = False
    window_open: float | None = None
    spans: list = field(default_factory=list)
    control_readings: dict = field(default_factory=dict)

    def open_window(self) -> float:
        self.window_open = time.perf_counter()
        return self.window_open

    @property
    def setup_s(self) -> float:
        return self.window_open - self.t_process

    def span(self, name: str, start: float, end: float) -> None:
        self.spans.append((name, start, end))


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end values (host clock), the
    counts, the checks (name, value, limit), the readings the per-layer
    readers take, and the device's peak."""

    end_to_end: dict
    attempted: int
    failed: int
    checks: list
    readings: dict
    memory_peak_bytes: int
    trace: object = None


def seeded_weights(cfg: dict, seed: int, device, names=None) -> dict:
    """{module: state dict} of the configuration's modules, drawn from
    ``seed`` on ``device``: one uniform draw a module from a generator on
    the device, cut into each tensor and scaled to the reference's
    initialisers' bounds (``reference/models.py::init_bounds``)."""
    import torch

    from portbench.reference.models import build, init_bounds

    out = {}
    for i, (name, module) in enumerate(build(cfg, "meta").items()):
        if names is not None and name not in names:
            continue
        bounds = init_bounds(name, module)
        shapes = {k: t.shape for k, t in module.state_dict().items()}
        total = sum(math.prod(s) for s in shapes.values())
        gen = torch.Generator(device).manual_seed((seed * 1_000_003 + 7919 * (i + 1)) % 2**63)
        u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
        state, off = {}, 0
        for key, shape in shapes.items():
            n = math.prod(shape)
            centre, half = bounds[key]
            state[key] = u[off:off + n].view(shape).mul(half).add_(centre)
            off += n
        out[name] = state
    return out


def reference_modules(cfg: dict, seed: int, device):
    """The plain reference's modules with the seeded weights, in float32
    with TF32 off."""
    import torch

    from portbench.reference.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modules = build(cfg, device)
    for name, state in seeded_weights(cfg, seed, device).items():
        modules[name].load_state_dict(state, strict=True)
    return modules


def port_config(ctx: Context, **overrides):
    """The port's ``Config`` for this cell: the dataset's preset, the
    configuration file's sizes, the run's seed, the checkout's data and the
    benchmark's tokenizer cache."""
    from consistent__style_transfer_torch.config import make_config

    c = ctx.config
    s = c["scorers"]
    kw = dict(data_dir=os.path.join(ctx.root, "data"), dump_dir=ctx.cache_dir,
              log_dir=os.path.join(ctx.tmp_dir, "log"), out_dir=os.path.join(ctx.tmp_dir, "out"),
              device=str(ctx.device), seed=ctx.seed, dtype=c["dtype"], vocab_size=c["vocab_size"],
              max_len=c["max_len"], batch_size=c["batch_size"], n_class=c["n_class"],
              p_drop=c["generator"]["p_drop"], scorer_layers=s["n_layers"],
              scorer_d_model=s["d_model"], scorer_heads=s["n_heads"])
    if "optimize" in c:
        o = c["optimize"]
        kw.update(optimize_lr=o["lr"], optimize_clip=o["clip"], d_update_every=o["d_update_every"],
                  megastep_k=o["megastep_k"], tau=o["tau"], gap=o["gap"], w_s=o["w_s"],
                  w_c=o["w_c"], w_adv=o["w_adv"], w_bt=o["w_bt"])
    kw.update(overrides)
    return make_config(c["dataset"], **kw)


def tokenizer(cfg):
    """The dataset's tokenizer: trained once by the port's own
    ``get_tokenizer`` into the benchmark's cache, then loaded from there."""
    from consistent__style_transfer_torch.train.common import get_tokenizer

    return get_tokenizer(cfg)


def line(outcome: Outcome, metrics: dict, device: dict, breakdown=None, control=None) -> dict:
    """The result line, its checks last (and, asked for, the control's
    readings before them)."""
    correct = all(v is not None and math.isfinite(v) and v <= lim
                  for _, v, lim in outcome.checks) and bool(outcome.checks)
    out = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control is not None:
        out["control"] = control
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return out


def print_checks(checks) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)
