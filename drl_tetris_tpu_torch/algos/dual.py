"""Dual-policy self-play: two policies trained against each other.

Counterpart of ``drl_tetris_tpu/algos/dual.py`` (the reference's
single_policy=False mode, worker.py:157-192, sventon_agent_base.py:96-111):
each policy controls one player and sees the other as part of the
environment.  Both nets act on every game each tick and the acting
player's policy is taken per game, so the tick stays one batched forward
per net and one launch of the engine kernel's one-tick entry, with no
host sync in the loop.  Each policy's transitions are stitched from
alternating ticks (worker.py:176-192, merge_from_stash):

    s'  = s_{t+2}           (the next state that policy observes)
    r'  = r_t - r_{t+1}     good news for the opponent is bad news for me
    d'  = d_t | d_{t+1}

GAE runs per policy over its own ticks with UNSIGNED gamma (the sign flip
exists only for single-policy perspective alternation,
sventon_agent_base.py:76).  ``WinRateTracker`` is the win-rate gate
(sventon_agent_dqn_trainer.py:16-18): a policy winning more than
0.5 + tolerance is not trained until the other catches up.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from drl_tetris_tpu_torch.algos.gae import sventon_gae
from drl_tetris_tpu_torch.algos.ppo import Batch, PPOConfig
from drl_tetris_tpu_torch.algos.rollout import (HParams, Segment, _finish,
                                                _tick, _tick_keys,
                                                action_size, make_policy_fn,
                                                rollout_gumbel)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.env.env import EnvState, TetrisVectorEnv
from drl_tetris_tpu_torch.utils import tracing


def make_dual_rollout_fn(env: TetrisVectorEnv, nets: Sequence, horizon: int,
                         distribution: str = "pi", **policy_kwargs):
    """rollout(env_state, key=None, gumbel=None, hp=None) -> (env_state',
    Segment, v_last (N,)) with ``nets[0]`` acting for player 0 and
    ``nets[1]`` for player 1; the Segment's ``player`` says which acted.
    PPONets (pi sampling) or QNets (epsilon or pareto).

    As in JAX, each tick's key is split into (k0, k1), one per policy, and
    every draw follows them: the pi or pareto noise of both policies and
    all ticks is drawn before the loop, (horizon, 2, N, R*W), unless
    ``gumbel`` gives it."""
    policies = [make_policy_fn(env, net, distribution, **policy_kwargs)
                for net in nets]

    shape = (2, env.n_games, action_size(nets[0]))

    def acting(env_state: EnvState, gumbel=None, key=None,
               hp: Optional[HParams] = None):
        keys = (None, None) if key is None else rng.split(key)
        outs = [p(env_state, None if gumbel is None else gumbel[i], k, hp)
                for i, (p, k) in enumerate(zip(policies, keys))]
        mine = env_state.current_player == 0

        def pick(a, b):
            return torch.where(mine.reshape((-1,) + (1,) * (a.ndim - 1)),
                               a, b)
        # both policies observe the same state: the observation is shared
        return (outs[0][0],) + tuple(pick(a, b) for a, b in
                                     zip(outs[0][1:], outs[1][1:]))

    @torch.no_grad()
    def rollout(env_state: EnvState, key=None, gumbel=None,
                hp: Optional[HParams] = None):
        with tracing.span("rollout"):
            gumbel = rollout_gumbel(key, horizon, shape, distribution,
                                    gumbel)
            keys, last_key = _tick_keys(key, horizon, distribution)
            ticks = []
            for k in range(horizon):
                env_state, seg = _tick(env, acting, env_state,
                                       None if gumbel is None else gumbel[k],
                                       keys[k], hp)
                ticks.append(seg)
            return _finish(env_state, ticks, acting, gumbel, last_key, hp)

    return rollout


def merge_dual_transitions(seg: Segment) -> Segment:
    """The stash/merge rewrite (worker.py:184-191): transition t gets
    r' = r_t - r_{t+1} and d' = d_t | d_{t+1}; the segment's final tick
    keeps its own (r, d)."""
    r, d = seg.reward, seg.done
    r_next = torch.cat([r[1:], torch.zeros_like(r[:1])])
    d_next = torch.cat([d[1:], torch.zeros_like(d[:1])])
    return seg._replace(reward=r - r_next, done=d | d_next)


def dual_policy_subsegment(merged: Segment, p: int) -> Segment:
    """Policy p's own ticks as a (T/2, N) Segment.  Players strictly
    alternate: per game, the even ticks if p acted at t = 0, else the odd
    ones."""
    even_first = merged.player[0] == p            # (N,)

    def take(a):
        m = even_first.reshape((1, -1) + (1,) * (a.ndim - 2))
        return torch.where(m, a[0::2], a[1::2])

    return Segment(*[take(a) for a in merged])


def split_dual_segment(cfg: PPOConfig, seg: Segment, v_last
                       ) -> Tuple[Batch, Batch, dict]:
    """Merge a (T, N) dual-policy segment and split it into one training
    batch per policy, GAE on each policy's ticks with unsigned gamma.
    Games whose first tick is the other policy's have no bootstrap value
    for this policy after their last tick: the done-masked GAE treats it
    as a truncation."""
    if seg.reward.shape[0] % 2:
        raise ValueError("dual-policy segments need an even horizon")
    merged = merge_dual_transitions(seg)

    def policy_batch(p):
        even_first = seg.player[0] == p
        sub = dual_policy_subsegment(merged, p)
        v_boot = torch.where(even_first, v_last, torch.zeros_like(v_last))
        adv, tgt, stats = sventon_gae(
            sub.reward, sub.done, sub.v_piece, sub.v_mean, v_boot,
            gamma=cfg.gamma, gae_lambda=cfg.gae_lambda,
            gve_lambda=cfg.gve_lambda)

        def flat(a):
            return a.reshape((-1,) + tuple(a.shape[2:]))
        return Batch(
            occ=flat(sub.occ), vec=flat(sub.vec), piece=flat(sub.piece),
            rot=flat(sub.rot), trans=flat(sub.trans),
            old_prob=flat(sub.prob), advantage=flat(adv),
            target_v=flat(tgt)), stats

    b0, s0 = policy_batch(0)
    b1, s1 = policy_batch(1)
    stats = {f"policy_0/{k}": v for k, v in s0.items()}
    stats.update({f"policy_1/{k}": v for k, v in s1.items()})
    return b0, b1, stats


@dataclasses.dataclass
class WinRateTracker:
    """EMA win rate of policy 0 and the training gate
    (sventon_agent_dqn_trainer.py:16-18, presets.py:179-180)."""
    lr: float = 0.02
    tolerance: float = 0.1
    rate_0: float = 0.5

    def update(self, winners) -> None:
        """winners: the games' last round winners (0/1; -1 ignored),
        folded in game order on the host (one transfer)."""
        w = winners.cpu().numpy() if torch.is_tensor(winners) \
            else np.asarray(winners)
        for x in w[w >= 0]:
            self.rate_0 = (1 - self.lr) * self.rate_0 + self.lr * (x == 0)

    def should_train(self, policy: int) -> bool:
        rate = self.rate_0 if policy == 0 else 1.0 - self.rate_0
        return rate <= 0.5 + self.tolerance
