"""Typed settings of the main path.

``python -m drl_tetris_tpu train`` layers the presets ``default sventon
sventon_ppo resblock experiment_sventon_ppo`` (drl_tetris_tpu/cli/main.py:
24-26, drl_tetris_tpu/config/presets.py); ``load("r5_learning")`` adds the
recipe of record on top (presets.py:217-224).  The JAX presets module
imports JAX, so the port keeps what those layerings resolve to as typed
defaults; a test holds them equal field by field.

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

from drl_tetris_tpu_torch.algos.ppo import CompressorConfig, PPOConfig
from drl_tetris_tpu_torch.config.parameter import (LinearParameter,
                                                   ParamLike, Parameter,
                                                   param_eval)
from drl_tetris_tpu_torch.env.env import EnvConfig
from drl_tetris_tpu_torch.models.nets import ModelConfig

_COMPRESSOR = CompressorConfig(lr=0.005, safety=3.0, clip_val=8.0,
                               cautious=False)
_DEFAULT_PPO = PPOConfig(
    clipping_parameter=0.15, value_loss=0.01, policy_loss=0.9,
    entropy_loss=0.0, nn_regularizer=1e-5, lr=1e-7, gamma=0.98,
    gae_lambda=0.7, single_policy=True, n_train_epochs=4, minibatch_size=64,
    compress_advantages=_COMPRESSOR, compress_value_loss=_COMPRESSOR,
    augment_data=False, workers_computes_advantages=True,
    n_step_value_estimates=1, time_to_reference_update=1)

# recipes layered on the default: the PPO fields and the raw value_lr
RECIPES = {
    "r5_learning": dict(
        value_lr=LinearParameter(1e-4, final_val=3e-5,
                                 time_horizon=10_000_000),
        ppo=dict(minibatch_size=64, entropy_loss=0.0,
                 entropy_floor_standalone=10.0, ppo_epsilon=0.05)),
}


@dataclasses.dataclass(frozen=True)
class MainPathConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = _DEFAULT_PPO
    n_envs: int = 30               # n_envs_per_thread
    horizon: int = 72              # cli --horizon default
    value_lr: ParamLike = Parameter(1e-7)   # raw schedule, per iteration
    train_distribution: str = "pi"
    eval_distribution: str = "pi"


def load(recipe: Optional[str] = None) -> MainPathConfig:
    """The default layering, or it with ``recipe`` (a key of RECIPES)
    layered on top."""
    if recipe is None:
        return MainPathConfig()
    r = RECIPES[recipe]
    ppo = dataclasses.replace(_DEFAULT_PPO, lr=param_eval(r["value_lr"]),
                              **r["ppo"])
    return MainPathConfig(ppo=ppo, value_lr=r["value_lr"])
