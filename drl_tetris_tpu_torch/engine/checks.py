"""Inputs and comparisons that hold the engine tick kernel against its plain
PyTorch version: a start state that reaches the kernel's edges, replayed
actions (macro, placement, pose lock and mixed kinds), and both entries run
beside the plain version.  ``chip_smoke.py`` and the engine tests share
them.
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
    and done, dones, rounds finished).  The plain chain runs once: the
    one-tick entry is held against it tick by tick, the T-tick entry
    against its last state."""
    n_ticks = ar.shape[0]
    ker = cuda_tick.rollout(cfg, start, n_ticks, actions=(ar, at))
    ks, ps = start, start
    step_err, n_done = 0.0, 0
    for tick in range(n_ticks):
        k = cuda_tick.step(cfg, ks, ar[tick], at[tick])
        p = step_plain(cfg, ps, ar[tick], at[tick])
        step_err = max(step_err, tick_err(k, p))
        (ks, _, kd), ps = k, p[0]
        n_done += int(kd.sum())
    step_err = max(step_err, max_abs_err(ks, ps))
    played = int((ker.rounds_played - start.rounds_played).sum())
    return max_abs_err(ker, ps), step_err, n_done, played


KIND_MODES = ("place", "pose", "mixed")


def kind_actions(cfg: EnvConfig, state: EnvState, mode: str,
                 rs: np.random.RandomState) -> tuple:
    """(kind, r, t, y) (N,) int32 for one tick of the one-tick entry's
    per-kind path: every game a placement ("place": r_rel 0..3, x_target
    -3..W+1), every game a pose lock ("pose": mostly a top-drop rest or a
    free pose up to 2 rows above it, else a random pose, which is mostly
    not possible), or each game one of the three kinds at random
    ("mixed"); a pose's rotation is the acting piece's own for one-
    rotation pieces, as the env gives it."""
    from drl_tetris_tpu_torch.engine import masks as M
    from drl_tetris_tpu_torch.engine import step as S
    from drl_tetris_tpu_torch.env.env import pose_rotation, take_player
    e = cfg.engine
    W, H = e.width, e.height
    dev = state.current_player.device
    n = state.current_player.shape[0]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    ps = state.engine.players
    p = state.current_player
    mask, rest = M.top_drop(e, take_player(ps.occ, p),
                            take_player(ps.piece, p), take_player(ps.rot, p))
    flat = mask.reshape(n, -1).float() + 1e-3          # illegal: rarely
    cell = torch.multinomial(flat, 1, generator=torch.Generator(
        device=dev).manual_seed(int(rs.randint(1 << 30))))[:, 0]
    r_pose, c_pose = cell // W, cell % W
    y_pose = rest.reshape(n, -1).gather(1, cell[:, None])[:, 0] - \
        t(rs.randint(0, 3, n) * (rs.rand(n) < 0.3))
    rand = t(rs.rand(n) < 0.15).bool()
    r_pose = torch.where(rand, t(rs.randint(0, 4, n)), r_pose)
    c_pose = torch.where(rand, t(rs.randint(-1, W + 1, n)), c_pose)
    y_pose = torch.where(rand, t(rs.randint(-2, H + 1, n)), y_pose)
    if mode == "place":
        kind = t(np.full(n, S.PLACE))
    elif mode == "pose":
        kind = t(np.full(n, S.POSE))
    else:
        kind = t(rs.randint(0, 3, n))
    r = torch.where(kind == S.MACRO, t(rs.randint(0, 4, n)),
                    torch.where(kind == S.PLACE, t(rs.randint(0, 4, n)),
                                pose_rotation(state, r_pose)))
    tt = torch.where(kind == S.MACRO, t(rs.randint(0, W, n)),
                     torch.where(kind == S.PLACE, t(rs.randint(-3, W + 2, n)),
                                 c_pose.to(torch.int32)))
    y = torch.where(kind == S.POSE, y_pose.to(torch.int32), 0)
    return kind, r.to(torch.int32), tt.to(torch.int32), y.to(torch.int32)


def compare_kinds(cfg: EnvConfig, start: EnvState, n_ticks: int, mode: str,
                  seed: int) -> tuple:
    """The one-tick entry's per-kind path against the plain version from
    ``start``, ``n_ticks`` ticks of ``kind_actions``: (max error over
    every tick's state, reward and done, dones)."""
    rs = np.random.RandomState(seed)
    ks, ps = start, start
    err, n_done = 0.0, 0
    for _ in range(n_ticks):
        kind, r, t, y = kind_actions(cfg, ks, mode, rs)
        k = cuda_tick.step(cfg, ks, r, t, kind, y)
        p = step_plain(cfg, ps, r, t, kind, y)
        err = max(err, tick_err(k, p))
        (ks, _, kd), ps = k, p[0]
        n_done += int(kd.sum())
    return err, n_done
