# Frozen copy of drl_tetris_tpu_torch/algos/gae.py at commit
# 0522b5deacbf29e64a07f002c2407ff1530df4d8, part of the
# benchmark's plain reference.  Changed from the copy: sventon_gae takes
# the dtype it computes in (float32 in the reference, bfloat16 in the
# control).
"""Generalized advantage estimation, sventon style.

Counterpart of ``drl_tetris_tpu/algos/gae.py`` (reference:
sventon_trajectory.adv_and_targets, agents/datatypes/trajectory.py:111-141),
as a reverse Python loop over the T ticks of a (T, N) segment:

  td1s[i]  = r[i] + gamma * vp[i+1] * (1 - d[i]) - vp[i]
  A_i      = td1s[i] + gamma * lam * A_{i+1} * (1 - d[i])
  W_i      = 1 + lam * W_{i+1} * (1 - d[i])
  est[i]   = (A_i + vp[i] - vm[i]) / W_i
  adv      = est(lam = gae_lambda)
  targets  = vm + est(lam = gve_lambda)

vp is the piece-conditional value and vm the piece-mean value.  The JAX
package's two quirks are kept: the TD errors run on vp and the piece
adjustment is (+vp - vm) (the reference calls adv_and_targets with its
value arguments swapped), and ``gamma`` arrives already negated in
single-policy self-play (``PPOConfig.effective_gamma``).  The carry resets
across a done tick; the last tick bootstraps from ``v_piece_last``.
"""
from __future__ import annotations

import torch


def _weighted_gae(td, dones, gamma, lam):
    """(A, W) of td's shape, each tick folding in the one after it."""
    A = torch.zeros_like(td[0])
    W = torch.zeros_like(td[0])
    As, Ws = [], []
    for i in reversed(range(td.shape[0])):
        keep = 1.0 - dones[i]
        A = td[i] + gamma * lam * A * keep
        W = 1.0 + lam * W * keep
        As.append(A)
        Ws.append(W)
    return torch.stack(As[::-1]), torch.stack(Ws[::-1])


def sventon_gae(rewards, dones, v_piece, v_mean, v_piece_last, *,
                gamma: float, gae_lambda: float, gve_lambda: float = 0.95,
                dtype=torch.float32):
    """(advantages, value_targets, stats) over a (T, N) segment.

    rewards/dones: (T, N); v_piece/v_mean: (T, N) values of the observed
    state from the acting player's view; v_piece_last: (N,) bootstrap value
    of the final state.  The stats are device tensors (population
    variances, as jnp.var)."""
    f = dtype
    r, d = rewards.to(f), dones.to(f)
    vp, vm = v_piece.to(f), v_mean.to(f)
    vp_next = torch.cat([vp[1:], v_piece_last[None].to(f)], dim=0)
    td = r + gamma * vp_next * (1.0 - d) - vp

    A_adv, W_adv = _weighted_gae(td, d, gamma, gae_lambda)
    advantages = (A_adv + vp - vm) / W_adv

    A_val, W_val = _weighted_gae(td, d, gamma, gve_lambda)
    value_adjustment = (A_val + vp - vm) / W_val
    targets = vm + value_adjustment

    stats = {
        "td/mean": td.mean(), "td/variance": td.var(unbiased=False),
        "advantages/mean": advantages.mean(),
        "advantages/variance": advantages.var(unbiased=False),
        "value_adjustments/mean": value_adjustment.mean(),
        "value_adjustments/variance": value_adjustment.var(unbiased=False),
    }
    return advantages, targets, stats
