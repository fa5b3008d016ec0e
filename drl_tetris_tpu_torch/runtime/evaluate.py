"""Round-robin evaluation: checkpoints play each other head to head.

Counterpart of ``drl_tetris_tpu/runtime/evaluate.py`` (reference:
scripts/eval.py:70-208): pair agents, alternate turns in the two-player
env, record winners on a scoreboard.  Every pair plays n_games matches in
lockstep with the seats swapped halfway.

The JAX package's choices that decide which winner is recorded are kept,
so ``argmax`` agents play the same games as there: the games reset from
``PRNGKey(seed)``; both policies act on every game each tick and the
acting player's action is taken; the winner is read once after each
chunk of 8 ticks and recorded only for newly finished games; each
pairing's seed is ``seed + 97 * p0 + p1``.  Each tick's env step is one
launch of the engine kernel's one-tick entry on the card.  ``pi`` and
pareto agents sample with a ``torch.Generator`` seeded with ``seed + 1``,
so their games match JAX's only in distribution; epsilon-greedy agents
follow JAX's key chain (``PRNGKey(seed + 1)``, one split per chunk of 8
ticks, one per tick, one per seat), so their games are JAX's.

Action-head agents (``kind="macro"``: PPONet and QNet) are ported: the
world-model and Sherlock kinds wait for the placement masks and their
agents (ROADMAP 11, 13), and rendering waits for ROADMAP 15.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from drl_tetris_tpu_torch.algos.rollout import (EPSILON_DISTRIBUTIONS,
                                                make_policy_fn)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
from drl_tetris_tpu_torch.utils.scoreboard import Scoreboard

CHUNK = 8    # ticks between winner reads (evaluate.py:172-186)


@dataclasses.dataclass
class EvalAgent:
    """An entrant: ``net`` is a PPONet or QNet holding the agent's weights
    (on the device the matches run on)."""
    name: str
    net: torch.nn.Module
    distribution: str = "argmax"   # eval_distribution (presets.py:128)
    # "macro": action-head nets emitting the (r, t) macro; the JAX
    # package's "world_model*" and "sherlock*" kinds are not ported
    kind: str = "macro"
    epsilon: float = 0.05          # for the epsilon distributions


def _check_agent(agent: EvalAgent):
    if agent.kind != "macro":
        raise NotImplementedError(
            f"{agent.name}: kind {agent.kind!r} agents wait for the "
            "placement masks and their agents (ROADMAP 11, 13)")


def play_match(env_cfg: EnvConfig, agents: Tuple[EvalAgent, EvalAgent],
               n_games: int = 16, max_ticks: int = 2000, seed: int = 0,
               render: bool = False) -> Tuple[int, int, int]:
    """agents[0] sits as player 0 in every game.  Returns (wins0, wins1,
    unfinished).  The games run on agents[0]'s device."""
    if render:
        raise NotImplementedError("rendering waits for ROADMAP 15")
    for a in agents:
        _check_agent(a)
    dev = next(agents[0].net.parameters()).device
    env = TetrisVectorEnv(env_cfg, n_games, device=dev)
    policies = [make_policy_fn(env, a.net, a.distribution,
                               epsilon=a.epsilon) for a in agents]
    st = env.reset(seed)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    keyed = any(a.distribution in EPSILON_DISTRIBUTIONS for a in agents)
    key = rng.prng_key(seed + 1, dev)
    seat_keys = (None, None)
    finished = np.zeros(n_games, bool)
    winner = np.full(n_games, -1)
    with torch.no_grad():
        for _ in range(0, max_ticks, CHUNK):
            done_any = torch.zeros(n_games, dtype=torch.bool, device=dev)
            if keyed:
                key, k = rng.split(key)
                tick_keys = rng.split(k, CHUNK)
            for i in range(CHUNK):
                if keyed:
                    seat_keys = rng.split(tick_keys[i])
                (_, _, r0, t0, *_), (_, _, r1, t1, *_) = [
                    p(st, generator, key=k)
                    for p, k in zip(policies, seat_keys)]
                mine = st.current_player == 0
                st, _, done = env.step(st, torch.where(mine, r0, r1),
                                       torch.where(mine, t0, t1))
                done_any |= done
            d, w = torch.stack([done_any.to(torch.int32),
                                env.get_winner(st).to(torch.int32)]
                               ).cpu().numpy()
            newly = d.astype(bool) & ~finished
            winner[newly] = w[newly]
            finished |= d.astype(bool)
            if finished.all():
                break
    wins0 = int((winner == 0).sum())
    wins1 = int((winner == 1).sum())
    return wins0, wins1, int((~finished).sum())


def round_robin(env_cfg: EnvConfig, agents: Sequence[EvalAgent],
                games_per_pair: int = 16, seed: int = 0,
                render: bool = False) -> Scoreboard:
    """All-pairs tournament with seat sides swapped halfway."""
    board = Scoreboard([a.name for a in agents])
    half = max(games_per_pair // 2, 1)
    for a, b in itertools.combinations(range(len(agents)), 2):
        for (p0, p1) in ((a, b), (b, a)):
            w0, w1, undecided = play_match(
                env_cfg, (agents[p0], agents[p1]), n_games=half,
                seed=seed + 97 * p0 + p1, render=render)
            for _ in range(w0):
                board.declare_winner(agents[p0].name, agents[p1].name)
            for _ in range(w1):
                board.declare_winner(agents[p1].name, agents[p0].name)
            for _ in range(undecided):
                board.declare_draw(agents[p0].name, agents[p1].name)
    return board
