#!/usr/bin/env python3
"""The port's spans over the benchmark's ``ppo_act`` segment on the card.

    python3 tools/torch_trace_spans.py [--seed N] [--pairs 6]

Builds the cell's program as ``benchmark/run.py`` does (1024 games x 64
ticks, the benchmark's weights, one warm-up segment), then:

* profiles one segment as the benchmark's traced unit does and prints the
  span summary (drl_tetris_tpu_torch/utils/tracing.py), the split of a
  tick (observe, forward, sample, env_step and the stream's time between
  them), ship and the host's time to issue a tick; two checks of the
  spans: the leaves and the stream's gaps between them against the
  ``rollout`` span, and the ``rollout`` span against the benchmark's own
  CUDA events around the same call; the offset of each leaf's host start
  from its profiler event (the clock); and the idle gaps by name;
* runs ``--pairs`` pairs of segments from the same start state and key,
  one with spans off and one with every span recording outside the
  profiler (in a ``tracing.Iteration(every_span=True)``), in turns, and
  prints the on-cost;
* prints the split of the last recording segment: the stream's times
  without the profiler.

The last line is a JSON object of the numbers.  Needs a CUDA device; the
engine kernel builds on first use.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LEAVES = ("observe", "forward", "sample", "env_step")


def split(spans):
    """The rollout's stream time, its leaves' and the gaps between
    consecutive leaves (and the rollout's ends), from the spans' CUDA
    events; read before the events are freed."""
    roll = next(s for s in spans if s.name == "rollout")
    leaves = [s for s in spans if s.name in LEAVES]
    edges = [roll.events[0]]
    for s in leaves:
        edges += list(s.events)
    edges.append(roll.events[1])
    edges[-1].synchronize()
    gaps = sum(a.elapsed_time(b) for a, b in zip(edges[::2], edges[1::2]))
    by_leaf = {n: sum(s.device_ms for s in leaves if s.name == n)
               for n in LEAVES}
    return {"rollout_ms": roll.device_ms, "leaves_ms": by_leaf,
            "glue_ms": gaps}


def layer_table(summary, ticks):
    rows = {}
    for name, d in sorted(summary.items()):
        rows[name] = {"count": d["count"], "device_ms": d["device_ms"],
                      "host_ms": d["host_ms"],
                      "device_ms_per_tick": (d["device_ms"] or 0.0) / ticks,
                      "host_ms_per_tick": d["host_ms"] / ticks}
    return rows


def traced(entry, system):
    from benchmark.trace import SPAN, reduce_events
    from drl_tetris_tpu_torch.utils import tracing
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            u = entry.unit(system)
    events = prof.profiler.kineto_results.events()
    red = reduce_events(events)
    spans = tracing.spans()
    parts = split(spans)
    starts = {}
    for e in events:
        if e.name() in LEAVES + ("ship.gae", "ship.copy") \
                and e.device_type() == torch.autograd.DeviceType.CPU:
            starts.setdefault(e.name(), []).append(e.start_ns())
    offsets = []
    for name, ev in starts.items():
        mine = sorted(s.start_ns for s in spans if s.name == name)
        offsets += [a - b for a, b in zip(mine, sorted(ev))]
    summary = tracing.summary(tracing.current_unit())
    return u, red, parts, offsets, summary


def on_cost(entry, s, pairs):
    """Seconds of segments from one start state and key, spans off and
    every span on (outside the profiler) in turns."""
    from drl_tetris_tpu_torch.utils import tracing
    off, on = [], []
    last = None
    for i in range(pairs):
        state, key = s.env_state, s.key.clone()
        for recording in ((False, True) if i % 2 == 0 else (True, False)):
            s.env_state, s.key = state, key.clone()
            tracing.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if recording:
                with tracing.Iteration("cuda", every_span=True):
                    entry.unit(s)
                on.append(time.perf_counter() - t0)
                last = tracing.summary(tracing.current_unit())
            else:
                entry.unit(s)
                off.append(time.perf_counter() - t0)
            s.segments.clear()
    return off, on, last


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234567890123)
    ap.add_argument("--pairs", type=int, default=6)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from benchmark import core

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    ctx = core.Context("ppo_act", opts.seed, "cuda")
    entry = ctx.entry()
    s = entry.build(ctx)
    for _ in range(2):
        entry.unit(s)
    torch.cuda.synchronize()
    u, red, parts, offsets, summary = traced(entry, s)
    ticks = u["ticks"]
    leaves = sum(parts["leaves_ms"].values())
    whole = leaves + parts["glue_ms"]
    out = {"card": smi, "ticks": ticks,
           "traced": layer_table(summary, ticks),
           "rollout_span_ms": parts["rollout_ms"],
           "rollout_event_ms": u["rollout_ms"],
           "rollout_vs_events": parts["rollout_ms"] / u["rollout_ms"] - 1,
           "leaves_ms": parts["leaves_ms"], "glue_ms": parts["glue_ms"],
           "leaves_glue_vs_rollout": whole / parts["rollout_ms"] - 1,
           "offset_ns": {"n": len(offsets),
                         "median": statistics.median(offsets),
                         "min": min(offsets), "max": max(offsets)},
           "busy_s": red["busy_s"], "window_s": red["window_s"],
           "idle_gaps": red["breakdown"]["idle_gaps"]}
    idle = red["window_s"] - red["busy_s"]
    out["idle_gap_shares"] = {n: v / idle for n, v in
                              red["breakdown"]["idle_gaps"]}
    print(f"traced segment: rollout span {parts['rollout_ms']:.3f} ms, "
          f"benchmark events {u['rollout_ms']:.3f} ms "
          f"({100 * out['rollout_vs_events']:+.3f}%); leaves "
          f"{leaves:.3f} + glue {parts['glue_ms']:.3f} = {whole:.3f} ms "
          f"({100 * out['leaves_glue_vs_rollout']:+.3f}%)", flush=True)
    for name, row in out["traced"].items():
        print(f"  {name:10s} x{row['count']:4d} device "
              f"{row['device_ms_per_tick']:8.4f} ms/tick host "
              f"{row['host_ms_per_tick']:8.4f} ms/tick")
    print(f"clock: leaf start - profiler event start, ns: "
          f"{out['offset_ns']}")
    print(f"idle gaps: {out['idle_gaps']}")
    off, on, last = on_cost(entry, s, opts.pairs)
    out.update(off_s=off, on_s=on,
               on_cost=statistics.median(on) / statistics.median(off) - 1,
               recording=layer_table(last, ticks))
    print(f"on-cost: spans off {statistics.median(off):.4f} s, recording "
          f"{statistics.median(on):.4f} s a segment (medians of "
          f"{opts.pairs}): {100 * out['on_cost']:+.3f}%")
    for name, row in out["recording"].items():
        print(f"  {name:10s} x{row['count']:4d} device "
              f"{row['device_ms_per_tick']:8.4f} ms/tick host "
              f"{row['host_ms_per_tick']:8.4f} ms/tick")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
