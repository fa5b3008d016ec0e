"""Self-play rollout: the worker's acting loop, observe -> net forward ->
sample -> env step, over a fixed horizon with auto-reset.

Counterpart of ``drl_tetris_tpu/algos/rollout.py`` (``HParams``,
``make_policy_fn``, ``make_rollout_fn``, ``make_pool_rollout_fn``).  The
JAX package scans the horizon inside one jitted program; here it is a
Python loop, and each tick's env step is one launch of the engine kernel's
one-tick entry on the card (engine/cuda_tick.py), between policy forwards.

The policy takes a PPONet (pi, v) or a QNet (Q, V, A), and samples with
``pi``, ``argmax``, ``epsilon``, ``adaptive_epsilon`` or
``pareto_distribution``.  Every draw follows JAX's keys: ``key`` is the
rollout's key, split into one per tick as JAX splits it (``split(key,
horizon)``; the pool rollout's pairs of ticks take the same keys in
order).  ``pi`` and pareto are ``jax.random.categorical`` of each tick's
key, whose gumbel noise depends on the keys only: the rollout draws the
noise of all its ticks in one batched threefry pass before the acting
loop, so the loop launches nothing for it.  ``gumbel`` ((horizon, N, R*W))
replaces that noise with given noise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from drl_tetris_tpu_torch.algos import distributions as D
from drl_tetris_tpu_torch.engine import cuda_tick, rng
from drl_tetris_tpu_torch.env.env import EnvState, TetrisVectorEnv
from drl_tetris_tpu_torch.env.observations import Obs
from drl_tetris_tpu_torch.utils import tracing


class HParams(NamedTuple):
    """Sampling hyperparameters the trainer evaluates per iteration from
    their schedules (tools/parameter.py:8-66), as host floats.
    ``avg_traj_len`` backs ``adaptive_epsilon`` (sventon_agent.py:87-89;
    EMA from sherlock_agent.py:39,173: init 12); the DQN trainer passes
    its EMA as a 0-d device tensor, so reading it costs no host sync."""
    epsilon: float = 0.05        # presets.py:81
    temperature: float = 1.0     # action_temperature
    avg_traj_len: float = 12.0   # sherlock_agent.py:39 init


EPSILON_DISTRIBUTIONS = ("epsilon", "adaptive_epsilon")
SAMPLED_DISTRIBUTIONS = ("pi", "pareto_distribution")
DISTRIBUTIONS = ("pi", "argmax", "pareto_distribution") \
    + EPSILON_DISTRIBUTIONS


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


def _values(out):
    """(scores (N, R, W, P), v (N, P|1)) of a PPONet's (pi, v) or a QNet's
    (Q, V, A): a QNet's scores are Q and its v the broadcast V."""
    if len(out) == 2:
        return out
    q, vq, _ = out
    return q, vq.reshape(q.shape[0], 1)


def _piece_values(v, piece):
    """(v(s | piece), v(s)) of (N, P|1) values."""
    idx = torch.arange(v.shape[0], device=v.device)
    v_piece = v[idx, piece.long()] if v.shape[-1] > 1 else v[:, 0]
    return v_piece, v.mean(-1)


def _check_device(env: TetrisVectorEnv, net):
    dev = next(net.parameters()).device
    if dev.type != env.device.type or (env.device.index is not None
                                       and dev.index != env.device.index):
        raise ValueError(f"the net is on {dev} and the env on {env.device}")


def make_policy_fn(env: TetrisVectorEnv, net, distribution: str = "pi",
                   epsilon: float = 0.05, temperature: float = 1.0):
    """sventon_agent.get_action (sventon_agent.py:56-98): net forward, a
    sample over the acting piece's (r, t) plane, and the recorded p(a)
    (the Q value for a QNet), v(s|piece), v(s).  The net's weights must be
    on the env's device.  Returns policy(env_state, gumbel=None,
    key=None, hp=None): ``key`` is the tick's (2,) threefry key, which the
    epsilon distributions split and ``pi`` and pareto draw their
    categorical from unless ``gumbel`` ((N, R*W)) gives its noise; ``hp``
    (HParams) overrides ``epsilon`` and ``temperature``."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(distribution)
    _check_device(env, net)

    def policy(env_state: EnvState, gumbel=None, key=None,
               hp: Optional[HParams] = None):
        if hp is None:
            hp = HParams(epsilon=epsilon, temperature=temperature)
        with tracing.leaf("observe"):
            obs = env.observe(env_state)
            vec, vis = policy_inputs(obs)
        with tracing.leaf("forward"):
            scores, v = _values(net(vec, vis))      # (N,4,W,7), (N,7|1)
        with tracing.leaf("sample"):
            piece = obs.piece[:, 0]
            n, R, W, P = scores.shape
            ppi = scores.gather(3, piece.long()[:, None, None, None].expand(
                n, R, W, 1))[..., 0]                # (N, 4, W)
            if gumbel is None and distribution in SAMPLED_DISTRIBUTIONS:
                gumbel = rng.gumbel(key.to(ppi.device), (n, R * W))
            if distribution == "pi":
                (r, t), _ = D.action_distribution(ppi, gumbel)
            elif distribution == "argmax":
                (r, t), _ = D.action_argmax(ppi)
            elif distribution == "epsilon":
                (r, t), _ = D.action_epsilongreedy(ppi, key, hp.epsilon)
            elif distribution == "adaptive_epsilon":
                # epsilon(t) scaled by 1 / avg trajectory length
                # (sventon_agent.py:87-89), in float32 as JAX computes it
                atl = hp.avg_traj_len
                if torch.is_tensor(atl):       # the trainer's device EMA
                    eps = float(np.float32(hp.epsilon)) / torch.clamp(
                        atl.to(torch.float32), min=1e-6)
                else:
                    eps = np.float32(hp.epsilon) / np.maximum(
                        np.float32(atl), np.float32(1e-6))
                (r, t), _ = D.action_epsilongreedy(ppi, key, eps)
            else:
                (r, t), _ = D.action_pareto(ppi, hp.temperature, gumbel)
            idx = torch.arange(n, device=ppi.device)
            prob = ppi[idx, r, t]
            v_piece, v_mean = _piece_values(v, piece)
        return (obs, piece, r.to(torch.int32), t.to(torch.int32), prob,
                v_piece, v_mean)

    return policy


def _tick_keys(key, horizon: int, distribution: str):
    """JAX's per-tick keys split(key, horizon) and the bootstrap key
    fold_in(key, horizon), for the distributions that read them."""
    if distribution not in EPSILON_DISTRIBUTIONS:
        return [None] * horizon, None
    if key is None:
        raise ValueError(f"distribution {distribution!r} needs the "
                         "rollout's key")
    return list(rng.split(key, horizon)), rng.fold_in(key, horizon)


def action_size(net) -> int:
    """R * T, the size of a net's action plane per piece."""
    return net.cfg.n_rotations * net.action_columns


def rollout_gumbel(key, horizon: int, shape, distribution: str,
                   gumbel=None):
    """The categorical noise of a rollout's ticks, (horizon, *shape):
    ``gumbel`` if given, else for ``pi`` and pareto JAX's draw from each
    tick's key of split(key, horizon) in one batched pass (``shape`` ends
    in (N, R*W); a leading 2 is the dual rollout's (k0, k1) = split of
    each tick's key); None for the other distributions."""
    if gumbel is not None or distribution not in SAMPLED_DISTRIBUTIONS:
        return gumbel
    if key is None:
        raise ValueError(f"distribution {distribution!r} needs the "
                         "rollout's key")
    keys = rng.split(key, horizon)
    if len(shape) == 3:
        keys = rng.split(keys, shape[0])
    return rng.gumbel(keys, tuple(shape[-2:]))


def _tick(env, policy, env_state, gumbel, key, hp, values=None):
    """One acting tick: (env_state', Segment of the tick).  ``values``,
    when given, recomputes v(s|piece), v(s) from the observation (the
    learner's values on an opponent's tick)."""
    with tracing.span("tick"):
        player = env_state.current_player
        obs, piece, r, t, prob, v_piece, v_mean = policy(
            env_state, gumbel, key, hp)
        if values is not None:
            v_piece, v_mean = values(obs, piece)
        with tracing.leaf("env_step"):
            occ = _perspective_occ(env_state, player)
            env_state, reward, done = env.step(env_state, r, t)
    return env_state, Segment(occ=occ, vec=obs.vec, piece=piece, rot=r,
                              trans=t, prob=prob, v_piece=v_piece,
                              v_mean=v_mean, reward=reward, done=done,
                              player=player)


def _finish(env_state, ticks, policy, gumbel, key, hp):
    """Stack the ticks; the bootstrap value of the final state (the next
    acting player's view; it does not depend on the sampled action, so a
    sampled policy gets zero noise and draws nothing)."""
    seg = Segment(*[torch.stack(xs) for xs in zip(*ticks)])
    _, _, _, _, _, v_piece_last, _ = policy(
        env_state, None if gumbel is None else torch.zeros_like(gumbel[0]),
        key, hp)
    if env_state.current_player.is_cuda:
        cuda_tick.raise_if_overflowed(env_state.current_player.device)
    return env_state, seg, v_piece_last


def make_rollout_fn(env: TetrisVectorEnv, net, horizon: int,
                    distribution: str = "pi", **policy_kwargs):
    """Returns rollout(env_state, key=None, gumbel=None, hp=None) ->
    (env_state', Segment, v_piece_last); ``key`` is the rollout's key
    (JAX's kroll)."""
    policy = make_policy_fn(env, net, distribution, **policy_kwargs)
    shape = (env.n_games, action_size(net))

    @torch.no_grad()
    def rollout(env_state: EnvState, key=None, gumbel=None,
                hp: Optional[HParams] = None):
        with tracing.span("rollout"):
            gumbel = rollout_gumbel(key, horizon, shape, distribution,
                                    gumbel)
            keys, last_key = _tick_keys(key, horizon, distribution)
            ticks = []
            for k in range(horizon):
                env_state, seg = _tick(env, policy, env_state,
                                       None if gumbel is None else gumbel[k],
                                       keys[k], hp)
                ticks.append(seg)
            return _finish(env_state, ticks, policy, gumbel, last_key, hp)

    return rollout


def make_pool_rollout_fn(env: TetrisVectorEnv, net, horizon: int,
                         distribution: str = "pi", **policy_kwargs):
    """Self-play against a frozen opponent (league-pool training): the
    learner ``net`` acts on its parity of ticks, the opponent on the
    other, and GAE runs on the learner's values at every tick (the
    opponent only chooses actions); ``pool_segment_to_batch`` keeps the
    learner's ticks.  Returns rollout(opp_net, env_state, key=None,
    gumbel=None, hp=None, learner_first=True) -> (env_state',
    Segment, v_piece_last); ``horizon`` must be even and ``learner_first``
    should alternate across iterations so the learner plays both seats.
    Every tick is one env step, one launch of the one-tick entry."""
    if horizon % 2:
        raise ValueError(f"the pool rollout's horizon {horizon} is odd")
    policy = make_policy_fn(env, net, distribution, **policy_kwargs)

    def learner_values(obs, piece):
        with tracing.leaf("forward"):
            vec, vis = policy_inputs(obs)
            _, v = _values(net(vec, vis))
            return _piece_values(v, piece)

    shape = (env.n_games, action_size(net))

    @torch.no_grad()
    def rollout(opp_net, env_state: EnvState, key=None, gumbel=None,
                hp: Optional[HParams] = None, learner_first: bool = True):
        opponent = make_policy_fn(env, opp_net, distribution,
                                  **policy_kwargs)
        seats = (policy, opponent) if learner_first else (opponent, policy)
        with tracing.span("rollout"):
            gumbel = rollout_gumbel(key, horizon, shape, distribution,
                                    gumbel)
            keys, last_key = _tick_keys(key, horizon, distribution)
            ticks = []
            for k in range(horizon):
                acting = seats[k % 2]
                env_state, seg = _tick(
                    env, acting, env_state,
                    None if gumbel is None else gumbel[k], keys[k], hp,
                    values=None if acting is policy else learner_values)
                ticks.append(seg)
            return _finish(env_state, ticks, policy, gumbel, last_key, hp)

    return rollout
