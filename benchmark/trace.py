"""The traced unit: one iteration or segment under ``torch.profiler`` after
the window, reduced to the device's busy time, its kernels by name and the
idle gaps by what the host was doing.  The method is that of
tools/torch_profile_selfplay.py (kernels: the profiler's CUDA events that
are no user annotation; busy: the union of their intervals), read from the
profiler's raw events so that a trace of some 10^6 events reduces in
seconds."""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List

import torch

SPAN = "bench.unit"
TOP = 10


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _outermost(intervals):
    """The intervals not nested in an earlier one, sorted by start."""
    out = []
    for s, e, name in sorted(intervals):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def reduce_events(events, top: int = TOP) -> Dict:
    """busy_s, window_s, the kernels as (name, seconds) and the breakdown
    of a profile whose events hold one ``bench.unit`` span.  An idle gap is
    named by the outermost host operation running at its midpoint
    ("python" where none runs)."""
    cuda = torch.autograd.DeviceType.CUDA
    span = next(e for e in events if e.name() == SPAN)
    w0, w1 = span.start_ns(), span.start_ns() + span.duration_ns()
    kernels, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and d > 0:
                kernels.append((e.name(), s, s + d))
        elif e.name() != SPAN and d > 0:
            host.append((s, s + d, e.name()))
    busy = _union((max(s, w0), min(t, w1)) for _, s, t in kernels
                  if t > w0 and s < w1)
    busy_ns = sum(t - s for s, t in busy)
    ops: Dict[str, float] = {}
    for name, s, t in kernels:
        ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
    tops = _outermost(host)
    starts = [s for s, _, _ in tops]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = tops[i][2] if i >= 0 and tops[i][1] > mid else "python"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    def ranked(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernels": [(n, (t - s) * 1e-9) for n, s, t in kernels
                        if s < w1 and t > w0],
            "breakdown": {"device_ops": ranked(ops),
                          "idle_gaps": ranked(gaps)}}


def profile_unit(unit: Callable[[], dict], device) -> Dict:
    """One unit under the profiler; its reduction, with the unit's own
    dict under "unit" and the reduction's seconds under "reduce_s"."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            u = unit()
    t0 = time.perf_counter()
    out = reduce_events(prof.profiler.kineto_results.events())
    out["unit"] = u
    out["reduce_s"] = time.perf_counter() - t0
    return out


def kernels_named(trace: Dict, names: List[str]):
    """The traced kernels whose name holds one of ``names``."""
    return [(n, s) for n, s in trace["kernels"] if any(k in n for k in names)]
