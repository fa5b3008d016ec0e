"""Reward shaping.

Counterpart of ``drl_tetris_tpu/algos/reward_shapers.py`` (reference:
agents/agent_utils/reward_shapers.py:8-24).  ``linear_reshaping`` smears
the terminal reward backwards over the trajectory with alternating signs
for single-policy self-play (consecutive steps belong to opposite players).
For a trajectory r_0..r_T (T the index of the terminal step):

    shaped_t = r_t + 2*amount*r_T/(T^2 - T) * t * (-1)^(t+T)   (t < T)
    shaped_T = (1 - amount) * r_T
    trajectories of fewer than 3 steps are unchanged.

Over a fixed-horizon (T, N) segment with auto-reset, a forward loop gives
each step's index within its trajectory, backward loops the distance to
the trajectory's done and its terminal reward, and T = idx + steps_to_done.
Steps whose trajectory does not finish inside the segment are unchanged;
a trajectory that began before the segment counts its index from the
segment's head, as in the JAX package.  The loops run over T on the
tensors' device.
"""
from __future__ import annotations

import torch


def linear_reshaping(amount: float, single_policy: bool = True):
    """Returns shape(rewards, dones) -> reshaped rewards over (T, N)."""

    def shape(rewards: torch.Tensor, dones: torch.Tensor) -> torch.Tensor:
        f = rewards.to(torch.float32)
        d = dones.to(torch.float32)
        Tseg = f.shape[0]

        # forward: index of each step within its trajectory (resets after
        # a done step)
        idx = torch.empty_like(f)
        cur = torch.zeros_like(f[0])
        for t in range(Tseg):
            idx[t] = cur
            cur = torch.where(d[t] > 0, 0.0, cur + 1.0)

        # backward: steps to the trajectory's done (0 at the done step,
        # Tseg when no done is inside the segment) and the terminal reward
        steps_to_done = torch.empty_like(f)
        rT = torch.empty_like(f)
        std = torch.full_like(f[0], float(Tseg))
        last = torch.zeros_like(f[0])
        for t in reversed(range(Tseg)):
            std = torch.where(d[t] > 0, 0.0, std + 1.0)
            last = torch.where(d[t] > 0, f[t], last)
            steps_to_done[t], rT[t] = std, last
        finishes = steps_to_done < Tseg

        T_traj = idx + steps_to_done
        # (-1)^(t+T) == (-1)^steps_to_done
        if single_policy:
            sign = torch.where(steps_to_done.to(torch.int32) % 2 == 0,
                               1.0, -1.0)
        else:
            sign = 1.0
        denom = torch.clamp(T_traj * T_traj - T_traj, min=1.0)
        smear = 2.0 * amount * rT / denom * idx * sign
        shaped = torch.where(d > 0, (1.0 - amount) * f,
                             torch.where(finishes, f + smear, f))
        return torch.where(T_traj < 2.0, f, shaped)

    return shape


def no_reshaping(*args, **kwargs):
    """reward_shapers.py:26-29."""
    def f(rewards, dones):
        return rewards
    return f


def make_shaper(name, amount: float, single_policy: bool = True):
    """Settings-driven construction: name in {None, "none", "no_reshaping",
    "linear_reshaping"}; None for no shaping."""
    if name in (None, "none", "no_reshaping"):
        return None
    if name == "linear_reshaping":
        return linear_reshaping(amount, single_policy=single_policy)
    raise ValueError(f"unknown reward_shaper {name!r}")
