#!/usr/bin/env python3
"""Readings that the limits of a cell's compared numbers are set from, in
one process on one card:

    python3 benchmark/calibrate.py --workload ppo_act \
        --seeds 11 12 13 --control-seeds 21 22 23 --fault-seeds 31 32 33

For each seed of ``--seeds`` a run of the cell as the benchmark runs it
(``--seconds``, default 0: one unit after set-up), its numbers; for each
of ``--control-seeds`` the control (the reference computed at the next
precision below the configuration's, in the program's place) judged by
the reference; for each of ``--fault-seeds`` a run with each of the
entry's faults planted in the program.  Prints one JSON line per reading
and, at the end, each number's largest program reading and smallest
control and fault readings.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload, seeds, control_seeds, fault_seeds, seconds,
             device="cuda", adjust=None):
    """(kind, seed, numbers) for every reading; ``adjust(ctx)`` edits a
    context before its run (the CPU tests' smaller sizes)."""
    from benchmark import core

    def context(seed):
        ctx = core.Context(workload, seed, device)
        if adjust is not None:
            adjust(ctx)
        return ctx
    for seed in seeds:
        out = core.run_cell(context(seed), seconds, False)
        yield "program", seed, out["numbers"]
    for seed in control_seeds:
        ctx = context(seed)
        entry = ctx.entry()
        yield "control", seed, core.judge_numbers(
            entry, entry.control_record(ctx), ctx)
    for seed in fault_seeds:
        ctx0 = context(seed)
        for name, fault in ctx0.entry().FAULTS.items():
            out = core.run_cell(context(seed), seconds, False, fault=fault)
            yield f"fault:{name}", seed, out["numbers"]


def summary(rows) -> dict:
    """Per number: the program's largest reading, and per other kind its
    smallest (a missing number counts as failed: infinity)."""
    out = {}
    for kind, _, nums in rows:
        for name, v in nums.items():
            if isinstance(v, str):
                continue
            v = float("inf") if v is None else v
            d = out.setdefault(name, {})
            if kind == "program":
                d[kind] = max(d.get(kind, v), v)
            else:
                d[kind] = min(d.get(kind, v), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    rows = []
    for kind, seed, nums in readings(args.workload, args.seeds,
                                     args.control_seeds, args.fault_seeds,
                                     args.seconds):
        rows.append((kind, seed, nums))
        print(json.dumps({"kind": kind, "seed": seed, "numbers": nums,
                          "t": time.time()}), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
