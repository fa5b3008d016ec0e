"""Vectorized two-player Tetris environment.

Counterpart of ``drl_tetris_tpu/env/env.py``: N independent two-player
games stepped in lockstep, with the worker-loop conventions of the
reference (per-game alternating current player, auto-reset of finished
games, zero-sum terminal reward).

``TetrisVectorEnv.step`` goes through ``engine/cuda_tick.step``: on CUDA
tensors that launches the one-tick entry of the engine kernel; on CPU
tensors it runs ``step_plain`` below, the plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.engine.core import (
    EngineConfig, EngineState, _Tree, tree_map,
)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine import step as S
from drl_tetris_tpu_torch.env.observations import Obs, observe as build_obs


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    engine: EngineConfig = EngineConfig()
    time_elapsed_each_action: int = 400   # presets.py:133
    # reward_fcn: zero-sum terminal base reward, optional combo shaping
    extra_rewards: bool = False
    reward_base_weight: float = 1.0
    reward_combo_weight: float = 0.0

    @property
    def n_rotations(self):
        return 4

    @property
    def n_translations(self):
        return self.engine.width


@dataclasses.dataclass
class EnvState(_Tree):
    engine: EngineState
    current_player: torch.Tensor  # (N,) int32, whose turn it is now
    key: torch.Tensor             # (N, 2) int32 (uint32 bits), per-game key
    rounds_played: torch.Tensor   # (N,) int32


def _reward(cfg: EnvConfig, eng: EngineState, player, done):
    """tetris_environment.reward_fcn: base = youdead - medead (both dead
    => -1), only at round end; optional combo-count shaping."""
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
    """One env tick for every game, in plain PyTorch: the acting player's
    (r, t) macro (null action for the opponent), time advance, auto-reset
    of finished games.  reward/done are the acting player's, taken before
    the reset."""
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


class TetrisVectorEnv:
    """N independent two-player games stepped in lockstep on ``device``
    (default the card)."""

    def __init__(self, cfg: EnvConfig, n_games: int, device=None):
        self.cfg = cfg
        self.n_games = n_games
        self.device = resolve_device(device)

    def reset(self, key) -> EnvState:
        """key: an int seed or (2,) key words (== jax PRNGKey data)."""
        if isinstance(key, int):
            key = rng.prng_key(key)
        key = rng.u32(key).to(self.device)
        kinit, kplayer, knext = rng.split(key, 3)
        eng = S.init(self.cfg.engine, rng.split(kinit, self.n_games))
        return EnvState(
            engine=eng,
            current_player=rng.randint(kplayer, (self.n_games,), 0, 2),
            key=rng.to_i32(rng.split(knext, self.n_games)),
            rounds_played=torch.ones(self.n_games, dtype=torch.int32,
                                     device=self.device))

    def step(self, state: EnvState, rotations, translations
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
        """(state', reward, done) for the acting player of this tick."""
        # cuda_tick imports this module (EnvConfig, EnvState, step_plain)
        from drl_tetris_tpu_torch.engine import cuda_tick
        return cuda_tick.step(self.cfg, state, rotations, translations)

    def observe(self, state: EnvState, player=None) -> Obs:
        p = state.current_player if player is None else player
        return build_obs(self.cfg.engine, state.engine, p)

    def get_winner(self, state: EnvState) -> torch.Tensor:
        """last_winner of the most recently finished round per game."""
        return state.engine.last_winner
