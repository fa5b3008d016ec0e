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

Agents of every kind meet: ``macro`` (PPONet and QNet, the (r, t) macro),
``world_model`` and ``world_model_full`` (SIXten's VNet, one-ply search
over the top-drop or the full placement set), ``sherlock`` and
``sherlock_full`` (SherlockNet's phi.delta placements).  Each tick, each
game takes the acting agent's make phase: one launch of the one-tick
entry, its macro-only instantiation when both agents are macro agents,
else its per-kind one (the JAX package's step, step_place, step_pose and
step_mixed* dispatch).  World-model and Sherlock agents draw from JAX's
key chain whatever their distribution (``pi`` is SIXten's ``boltzmann``),
so their games are JAX's.  Rendering waits for ROADMAP 15.
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
from drl_tetris_tpu_torch.engine import step as S
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
from drl_tetris_tpu_torch.utils.scoreboard import Scoreboard

CHUNK = 8    # ticks between winner reads (evaluate.py:172-186)
KINDS = ("macro", "world_model", "world_model_full", "sherlock",
         "sherlock_full")


@dataclasses.dataclass
class EvalAgent:
    """An entrant: ``net`` holds the agent's weights (on the device the
    matches run on): a PPONet or QNet for ``kind="macro"``, a VNet for
    "world_model"/"world_model_full", a SherlockNet for
    "sherlock"/"sherlock_full" (the "_full" kinds act on the top-drop and
    finesse placements through pose locks, the others on the top-drop
    grid)."""
    name: str
    net: torch.nn.Module
    distribution: str = "argmax"   # eval_distribution (presets.py:128)
    kind: str = "macro"
    epsilon: float = 0.05          # for the epsilon distributions


def _agent_policy(env, agent: EvalAgent):
    """(policy(st, generator, key) -> (r, t, y), its make phase, whether
    it reads the key)."""
    if agent.kind not in KINDS:
        raise ValueError(f"{agent.name}: unknown kind {agent.kind!r}")
    full = agent.kind.endswith("_full")
    space = "full" if full else "top_drop"
    if agent.kind == "macro":
        pol = make_policy_fn(env, agent.net, agent.distribution,
                             epsilon=agent.epsilon)

        def act(st, generator, key):
            _, _, r, t, *_ = pol(st, generator, key=key)
            return r, t, torch.zeros_like(r)
        return act, S.MACRO, agent.distribution in EPSILON_DISTRIBUTIONS
    if agent.kind.startswith("world_model"):
        from drl_tetris_tpu_torch.algos.sixten import make_sixten_policy
        d = {"pi": "boltzmann"}.get(agent.distribution, agent.distribution)
        pol = make_sixten_policy(env, agent.net, d, agent.epsilon, space)
    else:
        from drl_tetris_tpu_torch.algos.sherlock import make_sherlock_policy
        pol = make_sherlock_policy(env, agent.net, agent.distribution,
                                   agent.epsilon, space)

    def act(st, generator, key):
        out = pol(st, key)
        if full:
            return out[2], out[3], out[4]
        return out[2], out[3], torch.zeros_like(out[2])
    return act, (S.POSE if full else S.PLACE), \
        agent.distribution != "argmax"


def play_match(env_cfg: EnvConfig, agents: Tuple[EvalAgent, EvalAgent],
               n_games: int = 16, max_ticks: int = 2000, seed: int = 0,
               render: bool = False) -> Tuple[int, int, int]:
    """agents[0] sits as player 0 in every game.  Returns (wins0, wins1,
    unfinished).  The games run on agents[0]'s device."""
    if render:
        raise NotImplementedError("rendering waits for ROADMAP 15")
    dev = next(agents[0].net.parameters()).device
    env = TetrisVectorEnv(env_cfg, n_games, device=dev)
    (act0, kind0, keyed0), (act1, kind1, keyed1) = [
        _agent_policy(env, a) for a in agents]
    st = env.reset(seed)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    keyed = keyed0 or keyed1
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
                (r0, t0, y0), (r1, t1, y1) = (
                    act0(st, generator, seat_keys[0]),
                    act1(st, generator, seat_keys[1]))
                mine = st.current_player == 0
                r, t = torch.where(mine, r0, r1), torch.where(mine, t0, t1)
                if kind0 == kind1 == S.MACRO:
                    st, _, done = env.step(st, r, t)
                else:
                    st, _, done = env.step_kinds(
                        st, torch.where(mine, kind0, kind1), r, t,
                        torch.where(mine, y0, y1))
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
