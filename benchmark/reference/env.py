# Frozen copy of the plain parts of drl_tetris_tpu_torch/env/env.py at commit
# 0522b5deacbf29e64a07f002c2407ff1530df4d8 (EnvConfig, EnvState, _reward,
# step_plain, and TetrisVectorEnv.reset as the function ``reset``), part of
# the benchmark's plain reference.
"""Vectorized two-player Tetris in plain PyTorch: N games in lockstep,
per-game alternating current player, auto-reset of finished games,
zero-sum terminal reward."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from benchmark.reference.core import EngineConfig, EngineState, _Tree, \
    tree_map
from benchmark.reference import rng
from benchmark.reference import step as S


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    engine: EngineConfig = EngineConfig()
    time_elapsed_each_action: int = 400
    extra_rewards: bool = False
    reward_base_weight: float = 1.0
    reward_combo_weight: float = 0.0


@dataclasses.dataclass
class EnvState(_Tree):
    engine: EngineState
    current_player: torch.Tensor  # (N,) int32, whose turn it is now
    key: torch.Tensor             # (N, 2) int32 (uint32 bits), per-game key
    rounds_played: torch.Tensor   # (N,) int32


def _reward(cfg: EnvConfig, eng: EngineState, player, done):
    """base = youdead - medead (both dead => -1), only at round end;
    optional combo-count shaping."""
    dead = eng.players.dead
    me_dead = dead.gather(1, player.long()[:, None])[:, 0].to(torch.int32)
    you_dead = dead.gather(1, 1 - player.long()[:, None])[:, 0].to(
        torch.int32)
    base = torch.where((me_dead & you_dead) != 0, -1, you_dead - me_dead)
    base = torch.where(done, base, 0).to(torch.float32)
    if not cfg.extra_rewards:
        return base
    combo = eng.players.combo_count.gather(
        1, player.long()[:, None])[:, 0].to(torch.float32)
    return cfg.reward_base_weight * base + cfg.reward_combo_weight * combo


def step_plain(cfg: EnvConfig, state: EnvState, rotations, translations
               ) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """One env tick for every game with (r, t) macro actions: the acting
    player's action (null action for the opponent), time advance,
    auto-reset of finished games.  reward/done are the acting player's,
    taken before the reset."""
    player = state.current_player
    use = torch.arange(2, device=player.device)[None, :] == player[:, None]
    r2 = torch.where(use, rotations.to(torch.int32)[:, None], 0)
    t2 = torch.where(use, translations.to(torch.int32)[:, None], 0)
    eng = S.step_macro(cfg.engine, state.engine, use, r2, t2,
                       cfg.time_elapsed_each_action)
    done = eng.round_over
    reward = _reward(cfg, eng, player, done)
    both = rng.split2(rng.u32(state.key))                    # (N, 2, 2)
    key, reset_keys = both[:, 0], both[:, 1]
    eng_reset = S.reset(cfg.engine, eng, reset_keys)
    eng = tree_map(lambda a, b: S._sel(done, b, a), eng, eng_reset)
    return EnvState(engine=eng, current_player=1 - player,
                    key=rng.to_i32(key),
                    rounds_played=state.rounds_played + done.to(torch.int32)
                    ), reward, done


def reset(cfg: EnvConfig, key, n_games: int, device) -> EnvState:
    """n_games fresh games from the (2,) key words."""
    key = rng.u32(key).to(device)
    kinit, kplayer, knext = rng.split(key, 3)
    eng = S.init(cfg.engine, rng.split(kinit, n_games))
    return EnvState(
        engine=eng,
        current_player=rng.randint(kplayer, (n_games,), 0, 2),
        key=rng.to_i32(rng.split(knext, n_games)),
        rounds_played=torch.ones(n_games, dtype=torch.int32, device=device))
