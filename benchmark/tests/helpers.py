"""The benchmark's CPU tests run each cell at the configuration's widths
with a few games and ticks, so that a whole run takes seconds; the
benchmark runs the cells' own traffic."""
from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"worker_ppo": (8, 8)}


def shrink(ctx):
    """``ctx`` at the test size of its entry."""
    n, h = SIZES[ctx.workload["entry"]]
    ctx.workload["traffic"].update(n_envs=n, horizon=h)
    return ctx


def context(cell: str, seed: int, root: Path = ROOT):
    from benchmark import core
    return shrink(core.Context(cell, seed, "cpu", root=root))
