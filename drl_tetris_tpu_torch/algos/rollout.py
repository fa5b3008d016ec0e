"""Self-play rollout: the worker's acting loop, observe -> PPONet forward ->
sample -> env step, over a fixed horizon with auto-reset.

Counterpart of ``drl_tetris_tpu/algos/rollout.py`` (``make_rollout_fn``;
the pool rollout waits for a later slice).  The JAX package scans the
horizon inside one jitted program; here it is a Python loop, and each
tick's env step is one launch of the engine kernel's one-tick entry on the
card (engine/cuda_tick.py), between two policy forwards.

Sampling noise comes from an explicit ``torch.Generator``; ``gumbel``
((horizon, N, R*W)) replaces it with given noise, so a test can follow the
JAX rollout's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from drl_tetris_tpu_torch.algos import distributions as D
from drl_tetris_tpu_torch.engine import cuda_tick
from drl_tetris_tpu_torch.env.env import EnvState, TetrisVectorEnv
from drl_tetris_tpu_torch.env.observations import Obs


class Segment(NamedTuple):
    """A (T, N) rollout segment."""
    occ: torch.Tensor      # (T, N, 2, H) int32 bits, order [me, opponent]
    vec: torch.Tensor      # (T, N, 2, 12) float32
    piece: torch.Tensor    # (T, N) int32 acting piece
    rot: torch.Tensor      # (T, N) int32 chosen rotation
    trans: torch.Tensor    # (T, N) int32 chosen translation
    prob: torch.Tensor     # (T, N) float32 pi(a|s) at sample time
    v_piece: torch.Tensor  # (T, N) float32 v(s | piece)
    v_mean: torch.Tensor   # (T, N) float32 v(s)
    reward: torch.Tensor   # (T, N) float32
    done: torch.Tensor     # (T, N) bool
    player: torch.Tensor   # (T, N) int32 acting player


def _perspective_occ(env_state: EnvState, player) -> torch.Tensor:
    """(N, 2, H) boards ordered [acting player, opponent]."""
    occ = env_state.engine.players.occ                      # (N, P, H)
    idx = torch.stack([player, 1 - player], dim=1).long()
    return occ.gather(1, idx[:, :, None].expand(-1, -1, occ.shape[2]))


def policy_inputs(obs: Obs):
    """Split an Obs into the per-perspective input lists the nets take."""
    return [obs.vec[:, 0], obs.vec[:, 1]], [obs.vis[:, 0], obs.vis[:, 1]]


def make_policy_fn(env: TetrisVectorEnv, net, distribution: str = "pi"):
    """sventon_agent.get_action: net forward, a sample over the acting
    piece's (r, t) plane, and the recorded p(a), v(s|piece), v(s).  The
    net's weights must be on the env's device."""
    if distribution not in ("pi", "argmax"):
        raise NotImplementedError(
            f"distribution {distribution!r} waits for a later slice")
    dev = next(net.parameters()).device
    if dev.type != env.device.type or (env.device.index is not None
                                       and dev.index != env.device.index):
        raise ValueError(f"the net is on {dev} and the env on {env.device}")

    def policy(env_state: EnvState, generator=None, gumbel=None):
        obs = env.observe(env_state)
        vec, vis = policy_inputs(obs)
        pi, v = net(vec, vis)                       # (N,4,W,7), (N,7|1)
        piece = obs.piece[:, 0]
        n, R, W, P = pi.shape
        ppi = pi.gather(3, piece.long()[:, None, None, None].expand(
            n, R, W, 1))[..., 0]                    # (N, 4, W)
        if distribution == "pi":
            (r, t), _ = D.action_distribution(ppi, generator, gumbel)
        else:
            (r, t), _ = D.action_argmax(ppi)
        idx = torch.arange(n, device=ppi.device)
        prob = ppi[idx, r, t]
        v_piece = v[idx, piece.long()] if v.shape[-1] > 1 else v[:, 0]
        return (obs, piece, r.to(torch.int32), t.to(torch.int32), prob,
                v_piece, v.mean(-1))

    return policy


def make_rollout_fn(env: TetrisVectorEnv, net, horizon: int,
                    distribution: str = "pi"):
    """Returns rollout(env_state, generator=None, gumbel=None)
    -> (env_state', Segment, v_piece_last)."""
    policy = make_policy_fn(env, net, distribution)

    @torch.no_grad()
    def rollout(env_state: EnvState,
                generator: Optional[torch.Generator] = None, gumbel=None):
        ticks = []
        for k in range(horizon):
            player = env_state.current_player
            obs, piece, r, t, prob, v_piece, v_mean = policy(
                env_state, generator, None if gumbel is None else gumbel[k])
            occ = _perspective_occ(env_state, player)
            env_state, reward, done = env.step(env_state, r, t)
            ticks.append(Segment(occ=occ, vec=obs.vec, piece=piece, rot=r,
                                 trans=t, prob=prob, v_piece=v_piece,
                                 v_mean=v_mean, reward=reward, done=done,
                                 player=player))
        seg = Segment(*[torch.stack(xs) for xs in zip(*ticks)])
        # bootstrap value of the final state (next acting player's view);
        # it does not depend on the sampled action
        _, _, _, _, _, v_piece_last, _ = policy(
            env_state, generator,
            None if gumbel is None else torch.zeros_like(gumbel[0]))
        if env_state.current_player.is_cuda:
            cuda_tick.raise_if_overflowed(env_state.current_player.device)
        return env_state, seg, v_piece_last

    return rollout
