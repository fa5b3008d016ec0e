"""Typed settings of the main path.

``python -m drl_tetris_tpu_torch train`` layers the presets ``default
sventon sventon_ppo resblock experiment_sventon_ppo`` (``presets.CLI_PRESETS``,
as drl_tetris_tpu/cli/main.py:24-26 does); ``load("r5_learning")`` adds the
recipe of record on top (presets.py:217-224).  ``MainPathConfig`` is a view
of what ``presets.load`` resolves that layering to, so the presets are the
one source of truth.

The default layering: a 22 x 10 board with all seven pieces, two players,
400 ms per action, no extra rewards; the 'silver' net with a 5 x 64 3x3
tower and a 6 x 128 5x5 value tower in bfloat16; sampling from pi; PPO
with clip 0.15, value loss 0.01, policy loss 0.9, no entropy bonus, L2
1e-5, both compressors on, 4 epochs of minibatch 64, a constant lr of 1e-7;
30 games and a horizon of 72 per iteration (the CLI's ``--horizon``
default).  ``r5_learning`` sets the lr to a linear decay 1e-4 -> 3e-5 over
10M env-steps, ``entropy_floor_standalone`` 10 and ``ppo_epsilon`` 0.05.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from drl_tetris_tpu_torch.algos.ppo import PPOConfig
from drl_tetris_tpu_torch.config import presets
from drl_tetris_tpu_torch.config.parameter import ParamLike
from drl_tetris_tpu_torch.env.env import EnvConfig
from drl_tetris_tpu_torch.models.nets import ModelConfig

HORIZON = 72                       # the CLI's --horizon default


@dataclasses.dataclass(frozen=True)
class MainPathConfig:
    env: EnvConfig
    model: ModelConfig
    ppo: PPOConfig
    n_envs: int                    # n_envs_per_thread
    horizon: int                   # cli --horizon default
    value_lr: ParamLike            # raw schedule, per iteration
    train_distribution: str
    eval_distribution: str


def load(recipe: Optional[str] = None) -> MainPathConfig:
    """The CLI's default layering, or it with the preset ``recipe``
    layered on top."""
    fw = presets.load(presets.CLI_PRESETS + ((recipe,) if recipe else ()))
    return MainPathConfig(
        env=fw.env, model=fw.model, ppo=fw.ppo, n_envs=fw.n_envs,
        horizon=HORIZON, value_lr=fw.settings.get("value_lr", 1e-7),
        train_distribution=fw.train_distribution,
        eval_distribution=fw.eval_distribution)
