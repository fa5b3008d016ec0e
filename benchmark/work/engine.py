"""Bytes and integer operations of one launch of the engine's one-tick
entry, the benchmark's copies of chip_smoke.py at commit
0522b5deacbf29e64a07f002c2407ff1530df4d8: ``state_bytes`` (chip_smoke.py
lines 309-311), ``THREEFRY_OPS`` and ``tick_int_ops`` (lines 2364-2407) and
the one-tick entry's bytes (``step_bytes``, line 2472).  The state's
leaves are the reference engine's (benchmark/reference), the same layout
the kernel reads and writes."""
from __future__ import annotations

import functools

import torch

from benchmark.reference.compare import leaves
from benchmark.reference.core import EngineConfig
from benchmark.reference.env import EnvConfig, reset

THREEFRY_OPS = 79   # threefry2x32: key word 2 + 2 adds + 20 x (add, rotate,
                    # xor) + 5 x 3 key injections (a rotate is one SHF)


def env_config(config: dict) -> EnvConfig:
    e = dict(config["env"]["engine"])
    e["piece_map"] = tuple(e["piece_map"])
    rest = {k: v for k, v in config["env"].items() if k != "engine"}
    return EnvConfig(engine=EngineConfig(**e), **rest)


@functools.lru_cache(maxsize=8)
def _game_bytes(cfg: EnvConfig) -> int:
    st = reset(cfg, torch.tensor([0, 1]), 1, "cpu")
    return sum(t.numel() * t.element_size() for _, t in leaves(st))


def state_bytes(cfg: EnvConfig, n_games: int) -> int:
    """Bytes of the env state of n games (every leaf is per game)."""
    return n_games * _game_bytes(cfg)


def step_bytes(cfg: EnvConfig, n_games: int) -> int:
    """One launch's bytes: the state read and written once, the two int32
    actions read, the float32 reward and the bool done written."""
    return 2 * state_bytes(cfg, n_games) + 2 * 4 * n_games + 5 * n_games


def tick_int_ops(cfg: EnvConfig, reset_share: float, action_draw: bool,
                 kind: str = "macro") -> float:
    """32-bit integer and logic operations of one game-tick on the common
    path (the acting player's make phase of ``kind``: "macro", "place",
    "pose" or "mixed", a third of each; both players' finish phase),
    counted term by term from the tick's code; loops that stop early are
    counted at the trip count of a typical tick, low rather than high.
    Float32 operations (bag weights, payout) are a few dozen and run on
    the FP32 units; they are not counted."""
    e = cfg.engine
    H, W, CAP = e.height, e.width, e.garbage_cap
    draw = 2 * THREEFRY_OPS + 3          # uniform01(fold_in(key, counter))
    ext = 2 * H                          # (occ << 4) | walls, per row
    probe = 4 * 4                        # 4 piece rows x (index, shift,
                                         # and, test)
    macro = (ext
             + 1.5 * (8 + 3 * 8 + probe)  # rotations: mean r of 1.5, lookup,
                                          # range checks, the first kick
             + (W + 2) * (probe + 3)      # left and right slides: ~W+2 probes
             + ext + 4 * (H // 2) * 3     # hard drop: 4 rows scan ~H/2 rows
             + 4 * 5 + 4)                 # add the piece
    make = {"macro": macro,
            # placement: the rotations, one slide towards the target
            "place": macro - (W + 2) * (probe + 3) / 2 + 6,
            # pose lock: lookup, range checks, one probe, the hard drop
            "pose": ext + 8 + 4 * 4 + probe + ext + 4 * (H // 2) * 3
            + 4 * 5 + 4}
    make["mixed"] = (make["macro"] + make["place"] + make["pose"]) / 3
    macro = make[kind]
    finish = (6 * H                       # clear_lines: full test, move
              + 6                         # send_lines
              + 8 + draw + 4 + ext + probe  # new piece: copy, draw, spawn test
              + 40                        # delay check, FIFO front, combo
              + 5)                        # reward, snapshot, counts
    tick = (2 * THREEFRY_OPS              # the env key's split2
            + macro + 2 * finish + 15)    # both players; reward and flip
    reset_ops = (2 * THREEFRY_OPS + 2 * draw  # fold_in pair, >= 2 piece draws
                 + 2 * (2 * H + 2 * CAP + 25))  # restart both players
    ops = tick + reset_share * reset_ops
    if action_draw:                      # fold_in, fold_in, random_bits
        ops += 3 * THREEFRY_OPS + 4
    return ops
