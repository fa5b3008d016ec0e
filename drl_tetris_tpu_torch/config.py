"""Typed defaults of the main path.

``python -m drl_tetris_tpu train`` layers the presets ``default sventon
sventon_ppo resblock experiment_sventon_ppo`` (drl_tetris_tpu/config/
presets.py).  For the slice ported so far (env, PPONet, acting loop) that
resolves to the defaults below: a 22 x 10 board with all seven pieces, two
players, 400 ms per action, no extra rewards; the 'silver' net with a 5 x 64
3x3 tower and a 6 x 128 5x5 value tower, computed in bfloat16; sampling from
pi.  The JAX presets module imports JAX, so the port keeps its own copy;
a test holds the two equal.  The training settings (PPO, GAE, Adam) come
with the training slice.
"""
from __future__ import annotations

import dataclasses

from drl_tetris_tpu_torch.env.env import EnvConfig
from drl_tetris_tpu_torch.models.nets import ModelConfig


@dataclasses.dataclass(frozen=True)
class MainPathConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    train_distribution: str = "pi"
    eval_distribution: str = "pi"


def load() -> MainPathConfig:
    return MainPathConfig()
