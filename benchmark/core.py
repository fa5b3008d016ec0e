"""The benchmark's generic machinery, owned by no cell: the specification
files, the inputs made from the seed, the window, the metric readers, the
checks and the last line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its entry (``entries/<entry>.py``).  An
entry module provides

* ``build(ctx)`` -> system: the program built from the configuration,
  its inputs made from ``ctx`` (weights, keys), the shapes of the cell
  warmed up (set-up);
* ``unit(system)`` -> dict: one whole iteration or segment, ended with the
  device synchronised; ``env_steps`` and the counts the metric readers
  read;
* ``record(system)`` -> the data the judge needs, on the CPU;
* ``judge(record, ctx)`` -> {number: value}: the comparison with the
  plain reference, each number held to the cell's ``limits``.

A metric is ``metrics/<name>.py`` with ``read(run) -> float or None``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from benchmark.trace import profile_unit

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "drl_tetris_tpu")


def process_start_time() -> float:
    """The wall-clock time this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot, compared whole)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """A module from a file under the benchmark (a metric's name may hold
    dots, so files are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Context:
    """One run of one cell: its specification files, the seed and the
    devices.  ``device`` runs the program; the judge's engine replay runs
    on the CPU and its nets on ``device``."""

    def __init__(self, workload: str, seed: int, device="cuda",
                 root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.bench = read_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        self.workload = read_json(self.dir / "workloads" / f"{workload}.json")
        if self.workload["traffic"]["name"] != self.cell["traffic"]:
            raise SystemExit(f"{workload}: BENCHMARK.json names the traffic "
                             f"{self.cell['traffic']!r}, its file "
                             f"{self.workload['traffic']['name']!r}")
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = read_json(self.root / configs[self.cell["config"]]
                                ["file"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self.fault = None
        self.marks = []

    def mark(self, name: str) -> None:
        """A point of the set-up, by the wall clock (``run.py`` prints
        each against the process's start)."""
        self.marks.append((name, time.time()))

    def entry(self):
        e = self.workload["entry"]
        return load_module(self.dir / "entries" / f"{e}.py", f"entry_{e}")

    def weights_like(self, state_dict: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Float32 weights for every tensor of ``state_dict``, drawn on the
        device in one call: conv kernels N(0, 1/fan_in), other weights and
        biases N(0, 0.01), LayerNorm weight 1 and bias 0."""
        items = list(state_dict.items())
        total = sum(t.numel() for _, t in items)
        draw = torch.randn(total, generator=self.gen, device=self.device)
        out, at = {}, 0
        for name, t in items:
            x = draw[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
            if name.endswith("norm.weight"):
                x = torch.ones_like(x)
            elif name.endswith("norm.bias"):
                x = torch.zeros_like(x)
            elif t.ndim == 4:
                x = x / math.sqrt(t.shape[1] * t.shape[2] * t.shape[3])
            else:
                x = 0.01 * x
            out[name] = x.contiguous()
        return out

    def key(self) -> torch.Tensor:
        """A (2,) key of two 32-bit words (int64) on the device."""
        return torch.randint(0, 2 ** 32, (2,), generator=self.gen,
                             device=self.device, dtype=torch.int64)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(unit: Callable[[], dict], seconds: float):
    """Whole units back to back from the start; the window closes at the
    end of the first unit that ends at or after ``seconds``.  Returns
    (units, window seconds); each unit gains its ``seconds``."""
    units = []
    t0 = last = time.perf_counter()
    while True:
        u = unit()
        now = time.perf_counter()
        u["seconds"] = now - last
        last = now
        units.append(u)
        if now - t0 >= seconds:
            return units, now - t0


def metric_specs(bench: dict, cell: str, trace: bool):
    """The metrics a cell reports: with trace 0 its end-to-end metrics,
    with trace 1 its per-layer ones (each listing the cell, or without a
    list moving an end-to-end metric the cell reports)."""
    def listed(m):
        return m.get("workloads") is None or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metrics(specs, run: dict) -> Dict[str, dict]:
    out = {}
    for m in specs:
        reader = load_module(run["ctx"].dir / "metrics" / f"{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def hold(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number beside its limit; a number missing,
    not finite or above its limit fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def device_block(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def judge_numbers(entry, rec, ctx) -> Dict[str, float]:
    """The judge's numbers; outputs it cannot read (a batch of another
    shape, a missing leaf) give none, and so fail."""
    try:
        return entry.judge(rec, ctx)
    except (ValueError, RuntimeError, IndexError, KeyError):
        traceback.print_exc()
        return {}


def run_cell(ctx: Context, seconds: float, trace: bool,
             started: Optional[float] = None,
             fault: Optional[Callable] = None) -> dict:
    """Set-up, the window, the traced unit, the check: the result's
    object, its ``checks`` last.  ``fault(system)`` breaks the program's
    path once it is built, before any step the judge reads (the fault
    tests); it may return a function that undoes it."""
    started = time.time() if started is None else started
    entry = ctx.entry()
    undo = []
    if fault is not None:
        ctx.fault = lambda s: undo.append(fault(s))
    try:
        return _run(ctx, entry, seconds, trace, started)
    finally:
        for u in undo:
            if u is not None:
                u()


def _run(ctx, entry, seconds, trace, started) -> dict:
    system = entry.build(ctx)
    synchronize(ctx.device)
    ctx.mark("set-up")
    setup_s = time.time() - started
    units, window_s = run_window(lambda: entry.unit(system), seconds)
    traced = profile_unit(lambda: entry.unit(system), ctx.device) \
        if trace else None
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    rec = entry.record(system)
    del system
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    run = {"ctx": ctx, "setup_s": setup_s, "units": units,
           "window_s": window_s, "trace": traced}
    metrics = read_metrics(metric_specs(ctx.bench, ctx.name, trace), run)
    numbers = judge_numbers(entry, rec, ctx)
    correct, checks = hold(numbers, ctx.workload["limits"])
    out = {"correct": correct, "attempted": len(units), "failed": 0,
           "metrics": metrics, "device": device_block(ctx.device, peak),
           "setup_s": setup_s, "window_s": window_s, "numbers": numbers,
           "unit_s": [u["seconds"] for u in units]}
    if traced is not None:
        out["device"].update(busy_s=traced["busy_s"],
                             window_s=traced["window_s"])
        out["breakdown"] = traced["breakdown"]
    out["checks"] = checks
    return out
