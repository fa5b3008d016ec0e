#!/usr/bin/env python3
"""The benchmark of drl_tetris_tpu_torch on one card: one run of one cell.

    python3 benchmark/run.py --workload ppo_act --seed 1234567890123 \
        --seconds 51 --trace 0

Reads BENCHMARK.json and the cell's files (benchmark/workloads/<cell>.json,
its configuration and entry), builds the program with inputs made from
--seed, warms up, runs whole units (iterations or segments) for --seconds,
with --trace 1 profiles one more unit, then holds what the program
produced against the plain reference (benchmark/reference).  The last
lines on standard error give each compared number beside its limit; the
last line on standard output is the result's JSON object.

Exits non-zero with no result when no card is visible, and when JAX or
the JAX package is loaded once the window has closed.  Build and kernel
caches go to build/ inside the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the engine kernel builds into build/torch_kernels/ by itself)."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import core
    import torch

    started = core.process_start_time()
    ctx = core.Context(args.workload, args.seed, "cuda")
    ctx.mark("imports")
    chips = ctx.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no run: the cell asks for {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from benchmark.work import peaks
    print(f"card: {torch.cuda.get_device_name(0)}, power limit "
          f"{peaks.smi('power.limit')} W", file=sys.stderr)
    result = core.run_cell(ctx, args.seconds, bool(args.trace), started)
    found = core.forbidden_modules()
    if found:
        print(f"no result: modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    extra = {k: v for k, v in result.pop("numbers").items()
             if k not in result["checks"]}
    if extra:
        print(f"judge: {json.dumps(extra)}", file=sys.stderr)
    print(f"run: {args.workload} seed {args.seed} setup_s "
          f"{result.pop('setup_s')!r} window_s {result.pop('window_s')!r} "
          f"units {result['attempted']} unit_s "
          f"{json.dumps(result.pop('unit_s'))}", file=sys.stderr)
    print("set-up: " + ", ".join(f"{name} {t - started:.3f} s"
                                 for name, t in ctx.marks), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
