"""Inputs and comparisons that hold the engine tick kernel against its plain
PyTorch version: a start state that reaches the kernel's edges, replayed
actions, and both entries run beside the plain version.  ``chip_smoke.py``
and the engine tests share them.
"""
from __future__ import annotations

import numpy as np
import torch

from drl_tetris_tpu_torch.engine import cuda_tick
from drl_tetris_tpu_torch.engine.core import tree_leaves
from drl_tetris_tpu_torch.env.env import EnvConfig, EnvState, step_plain


def max_abs_err(a: EnvState, b: EnvState) -> float:
    """Largest |a - b| over every leaf of two state trees (0 == bit
    exact: integer leaves compare their bit patterns)."""
    worst = 0.0
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"leaf {name}: {x.shape}/{x.dtype} vs "
                                 f"{y.shape}/{y.dtype}")
        if x.dtype == torch.float32:
            if torch.equal(x.view(torch.int32), y.view(torch.int32)):
                continue
            e = (x.double() - y.double()).abs().nan_to_num(float("inf"))
            # bits differ even where values are equal (-0.0, NaN payloads)
            worst = max(worst, e.max().item(), 2.0 ** -149)
        else:
            e = (x.long() - y.long()).abs().max().item()
            worst = max(worst, float(e))
    return worst


def tick_err(a: tuple, b: tuple) -> float:
    """Largest |a - b| of two ticks' (state', reward, done)."""
    (sa, ra, da), (sb, rb, db) = a, b
    return max(max_abs_err(sa, sb), (ra - rb).abs().max().item(),
               float((da != db).sum().item()))


def crowded(cfg: EnvConfig, state: EnvState, seed: int) -> EnvState:
    """``state`` with crowded garbage FIFOs (up to garbage_cap pending
    entries of 1-3 lines, rising delays), fractional incoming lines and up
    to H/2 garbage rows at the bottom of each board: a start state that
    reaches every FIFO slot and the full-FIFO path.  Half of the boards
    have their holes in one column (a well, for 4-line clears), and some
    rows have no hole (more than 4 full rows drop the rows above them)."""
    e = cfg.engine
    H, W, CAP = e.height, e.width, e.garbage_cap
    n = state.current_player.shape[0]
    rs = np.random.RandomState(seed)
    size = rs.randint(0, CAP + 1, (n, 2))
    live = np.arange(CAP)[None, None, :] < size[..., None]
    count = np.where(live, rs.randint(1, 4, (n, 2, CAP)), 0)
    delay = np.where(live, np.cumsum(rs.randint(0, 300, (n, 2, CAP)), -1),
                     0)
    rows = rs.randint(0, H // 2 + 1, (n, 2))
    hole = np.where(rs.rand(n, 2, 1) < 0.5, rs.randint(0, W, (n, 2, 1)),
                    rs.randint(0, W, (n, 2, H)))
    hole = np.where(rs.rand(n, 2, H) < 0.1, W, hole)      # W: no hole
    garbage = ((1 << W) - 1) & ~(1 << hole)
    filled = np.arange(H)[None, None, :] >= H - rows[..., None]
    board = np.where(filled, garbage, 0).astype(np.int32)
    inc = rs.randint(0, 12, (n, 2)).astype(np.float32) / 4
    dev = state.current_player.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ps = state.engine.players.replace(
        g_size=t(size.astype(np.int32)), g_count=t(count.astype(np.int32)),
        g_delay=t(delay.astype(np.int32)), occ=t(board), garb=t(board),
        incoming_lines=t(inc))
    return state.replace(engine=state.engine.replace(players=ps))


def replayed_actions(cfg: EnvConfig, n_ticks: int, n: int, seed: int,
                     device) -> tuple:
    """(rotations, translations): two (n_ticks, n) int32 tensors of
    uniformly drawn macro actions on ``device``."""
    rs = np.random.RandomState(seed)
    ar = rs.randint(0, 4, (n_ticks, n)).astype(np.int32)
    at = rs.randint(0, cfg.engine.width, (n_ticks, n)).astype(np.int32)
    return torch.from_numpy(ar).to(device), torch.from_numpy(at).to(device)


def compare_entries(cfg: EnvConfig, start: EnvState, ar, at) -> tuple:
    """Both entries against the plain version from ``start`` with replayed
    actions: (T-tick error, one-tick error over every tick with reward
    and done, dones, rounds finished)."""
    n_ticks = ar.shape[0]
    ker = cuda_tick.rollout(cfg, start, n_ticks, actions=(ar, at))
    ref = cuda_tick.rollout_plain(cfg, start, n_ticks, actions=(ar, at))
    roll_err = max_abs_err(ker, ref)
    ks, ps = start, start
    step_err, n_done = 0.0, 0
    for tick in range(n_ticks):
        k = cuda_tick.step(cfg, ks, ar[tick], at[tick])
        p = step_plain(cfg, ps, ar[tick], at[tick])
        step_err = max(step_err, tick_err(k, p))
        (ks, _, kd), ps = k, p[0]
        n_done += int(kd.sum())
    step_err = max(step_err, max_abs_err(ks, ref))
    played = int((ker.rounds_played - start.rounds_played).sum())
    return roll_err, step_err, n_done, played
